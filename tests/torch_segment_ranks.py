"""What tests/test_torch_segment.py runs in its rank subprocesses (and in its
own process, as the one-process reference): a seeded tiny segmented model
(``model()``) and ``roundtrip_parallel`` of seeded clips. It imports torch and
the port only, so that a rank starts without JAX.

A rank runs ``python tests/torch_segment_ranks.py RANK WORLD INIT OUT``: it
joins the gloo process group at ``INIT`` (a ``file://`` URL), codes every clip
of ``CLIPS`` (full-segment counts the ranks divide, and one they do not), and
saves each clip's frames and wav to ``OUT``.
"""

import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from encodec_pytorch_tpu_torch.models.model import EncodecModel  # noqa: E402
from encodec_pytorch_tpu_torch.parallel import mesh  # noqa: E402
from encodec_pytorch_tpu_torch.parallel.segment import (decode_parallel,  # noqa: E402
                                                        encode_parallel)

# the JAX package's tests/test_segment_parallel.py model: 0.1 s segments
CONFIG = dict(target_bandwidths=[1.5, 3.], sample_rate=24000, channels=1, causal=False,
              model_norm='time_group_norm', audio_normalize=True, segment=0.1, n_q=2,
              n_filters=4)
STRIDE = 2376                                   # 0.99 of a 2400-sample segment
# name: (batch, samples): 8 full segments and a tail (4 rows a rank at 2
# ranks), and 3 and a tail. oneDNN picks its conv algorithms by the batch: a
# call of 1, 2 or 8 rows of this model rounds otherwise than the same rows inside a call
# of twice as many, one of 3 to 7 rows does not, so a rank codes 4 rows
CLIPS = {'divisible': (1, 7 * STRIDE + 2400 + 700), 'not divisible': (1, 2 * STRIDE + 2400 + 300)}


def model() -> EncodecModel:
    m = EncodecModel._get_model(**CONFIG, generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    for layer in m.quantizer.vq.layers:
        layer._codebook.embed.normal_(generator=gen)
    m.set_target_bandwidth(3.)
    return m


def clip(name: str) -> torch.Tensor:
    batch, samples = CLIPS[name]
    rng = np.random.default_rng(len(name))
    return torch.from_numpy((rng.standard_normal((batch, 1, samples)) * 0.2).astype(np.float32))


def run(dp: Optional[mesh.DataParallel] = None) -> Dict[str, dict]:
    """Each clip's frames (codes, scales) and wav through the parallel path."""
    m = model()
    out = {}
    for name in CLIPS:
        x = clip(name)
        frames = encode_parallel(m, x, dp)
        out[name] = {'codes': [c for c, _ in frames], 'scales': [s for _, s in frames],
                     'wav': decode_parallel(m, frames, dp)[:, :, :x.shape[-1]]}
    return out


def launch(out_prefix: str, world: int = 2) -> List[subprocess.Popen]:
    """Start ``world`` rank subprocesses; rank r saves to ``{out_prefix}{r}.pt``."""
    init = f'file://{out_prefix}rendezvous'
    env = dict(os.environ, OMP_NUM_THREADS='1')
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), init,
                              f'{out_prefix}{r}.pt'], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def main(argv) -> int:
    rank, world, init, out_path = argv
    torch.set_num_threads(1)
    dp = mesh.initialize_distributed('cpu', init, int(rank), int(world))
    try:
        torch.save(run(dp), out_path)
    finally:
        dp.close()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
