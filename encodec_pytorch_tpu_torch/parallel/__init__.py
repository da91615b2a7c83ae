"""Data parallelism over ``torch.distributed`` (``mesh.py``) and
segment-parallel inference (``segment.py``)."""

from .mesh import (DataParallel, assert_replicated, initialize_distributed,  # noqa: F401
                   launcher_world_size, local_device, replica_checksums)
