"""Data parallelism over ``torch.distributed``.

Port of ``encodec_pytorch_tpu/parallel/mesh.py`` for data parallelism. The
JAX package runs one SPMD program over a device mesh: the state is replicated,
the batch is sharded on the ``data`` axis, and XLA inserts the collectives
(gradient psums, the balancer's global norms, the RVQ's EMA statistics). Here
each process (rank ``r`` of ``n``, one card each) runs the step on its rows of
the global batch, ``[r·B/n, (r+1)·B/n)``, and the step makes those collectives
itself through a :class:`DataParallel` handle: sum and max all-reduces, on the
card by NCCL and on the CPU by gloo (which also takes CUDA tensors, staged
through the host). Every rank ends each step with the same state, bit for bit,
which :func:`assert_replicated` checks.

No mesh or sharding objects are ported: torch has no counterpart for them,
and with one card a process there is nothing to lay out.

Launch: ``torchrun --nproc_per_node N -m encodec_pytorch_tpu_torch.train_cli``
(torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``); a ``file://`` or ``tcp://`` init method with an explicit
rank and world size also works (the tests use ``file://``).
"""

import os
import time
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

Device = Union[str, torch.device]


def launcher_world_size() -> int:
    """How many processes the run has: the process group's size when one is
    initialised, else torchrun's ``WORLD_SIZE``, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get('WORLD_SIZE', '1') or 1)


def local_device(device: Device) -> torch.device:
    """The card of this process: ``cuda`` without an index is
    ``cuda:LOCAL_RANK`` (0 without a launcher); anything else as given."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0') or 0))
    return device


class DataParallel:
    """This process's place in a data-parallel run (``rank`` of ``world``)
    and the collectives of the training step, each an all-reduce over the
    process group (``backend``: ``nccl`` or ``gloo``). ``device`` is where
    the handle's own buffers live (the current card under NCCL, else the
    CPU). With ``timed`` set, each
    collective is timed, on a CUDA tensor by CUDA events around it on the
    current stream (the device time the step's stream spends in it, with no
    sync added), else by the host clock; :meth:`collective_ms` sums them."""

    def __init__(self, group=None, owned: bool = False):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.device = (torch.device('cuda', torch.cuda.current_device())
                       if self.backend == 'nccl' else torch.device('cpu'))
        self.owned = owned          # close() destroys the group
        self.timed = False
        self.collectives = 0        # timed collectives so far
        self._ms = 0.0
        self._events: List[tuple] = []

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if not self.timed:
            dist.all_reduce(t, op=op, group=self.group)
            return t
        self.collectives += 1
        if t.is_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            dist.all_reduce(t, op=op, group=self.group)
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            dist.all_reduce(t, op=op, group=self.group)
            self._ms += 1e3 * (time.perf_counter() - t0)
        return t

    def collective_ms(self) -> float:
        """Milliseconds in the timed collectives so far (waits for the card)."""
        if self._events:
            self._events[-1][1].synchronize()
            self._ms += sum(start.elapsed_time(end) for start, end in self._events)
            self._events = []
        return self._ms

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (every rank gets the same
        bits); returns ``t``."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s elementwise maximum over the ranks, in place."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def sum_flat_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum every tensor of ``tensors`` (one dtype, one device) over the
        ranks in one all-reduce of a flat buffer, in place: the JAX step's
        gradient psum."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.sum_(flat)
        torch._foreach_copy_(tensors, [f.view_as(t) for f, t in
                                       zip(flat.split([t.numel() for t in tensors]), tensors)])

    def all_(self, ok: torch.Tensor) -> torch.Tensor:
        """A 0-d bool: ``ok`` on every rank (nothing read on the host)."""
        bad = (~ok).to(torch.float32).reshape(1)
        self.max_(bad)
        return bad[0] == 0

    def gather_rows(self, local: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of the global ``[world·M, D]`` array whose rows
        ``[rank·M, (rank+1)·M)`` are ``local [M, D]`` on this rank (every rank
        holds ``M`` rows and passes the same ``idx``): each rank writes the
        rows it owns into a zero ``[len(idx), D]`` buffer and the buffers are
        summed. No rank gathers the whole array."""
        m = local.shape[0]
        at = idx.to(local.device).long() - self.rank * m
        own = (at >= 0) & (at < m)
        rows = local[at.clamp(0, m - 1)]
        return self.sum_(torch.where(own[:, None], rows, torch.zeros_like(rows)))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t`` in rank order, each rank
        writing its own row of a zero buffer on ``device`` that is summed (an
        all-gather as an all-reduce, which gloo also takes on CUDA tensors)."""
        table = torch.zeros((self.world,) + tuple(t.shape), dtype=t.dtype, device=self.device)
        table[self.rank] = t
        return self.sum_(table)

    def barrier(self) -> None:
        """Wait until every rank got here."""
        self.sum_(torch.zeros(1, device=self.device))[0].item()

    def close(self) -> None:
        """Destroy the process group if :func:`initialize_distributed` made it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        self.owned = False


def initialize_distributed(device: Device = 'cuda', init_method: str = 'env',
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> Optional[DataParallel]:
    """The run's :class:`DataParallel`, or None for a one-process run.

    A process group the caller already initialised is used as it is.
    Otherwise ``init_method`` ``env`` reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and, with no
    ``WORLD_SIZE`` there, does nothing; a ``file://`` or ``tcp://`` URL
    rendezvouses there, with ``rank`` and ``world_size`` given or read from
    ``RANK`` and ``WORLD_SIZE``. The backend is NCCL for a CUDA ``device``
    (set as the current card first) and gloo otherwise.
    """
    if dist.is_initialized():
        return DataParallel()
    if init_method in ('env', 'env://'):
        if 'WORLD_SIZE' not in os.environ:
            return None
        init_method = 'env://'
    rank = int(os.environ.get('RANK', '0')) if rank is None else int(rank)
    world_size = launcher_world_size() if world_size is None else int(world_size)
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                            init_method=init_method, rank=rank, world_size=world_size)
    return DataParallel(owned=True)


def replica_checksums(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[len(tensors), 2]`` float64 on the CPU: each tensor's sum
    and the sum of its bytes read as integers (a bit-level checksum)."""
    out = []
    for t in tensors:
        t = t.detach().contiguous()
        nbytes = t.numel() * t.element_size()
        raw = t.reshape(-1).view(torch.uint8)[:nbytes - nbytes % 4].view(torch.int32)
        out.append(torch.stack([t.double().sum(), raw.double().sum()]).cpu())
    return torch.stack(out) if out else torch.zeros(0, 2, dtype=torch.float64)


def assert_replicated(dp: Optional[DataParallel], tensors: Sequence[torch.Tensor]) -> None:
    """Raise if the nominally replicated ``tensors`` (parameters, optimizer
    and codebook state; the same list on every rank) differ between ranks:
    their checksums (:func:`replica_checksums`) are gathered
    (:meth:`DataParallel.all_gather`) and compared with rank 0's. A
    one-process run has nothing to check."""
    if dp is None or dp.world == 1:
        return
    tensors = list(tensors)
    table = dp.all_gather(replica_checksums(tensors)).cpu()
    differ: List[int] = [r for r in range(1, dp.world) if not torch.equal(table[r], table[0])]
    if differ:
        bad = [i for i in range(len(tensors))
               if any(not torch.equal(table[r, i], table[0, i]) for r in differ)]
        raise AssertionError(f'replicated state diverged across ranks: ranks {differ} differ '
                             f'from rank 0 in tensors {bad[:10]} of {len(tensors)}')
