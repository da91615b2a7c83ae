"""What tests/test_torch_ddp.py runs both in its own process (one process on
the global batch) and in its rank subprocesses (2 ranks over gloo, each on
its rows of the global batch): seeded tiny modules, a few training steps of
the port with given choices, and the state after each step. It imports torch
and the port only, so that a rank subprocess starts without JAX.

A rank subprocess runs ``python tests/torch_ddp_steps.py RANK WORLD INIT SPEC
OUT``: it joins the process group at ``INIT`` (a ``file://`` URL), runs every
scenario of the ``SPEC`` file (``torch.save``'d) on its rows, checks with
``assert_replicated`` that the ranks' states agree, and saves its results to
``OUT``. With ``WORLD`` 1 it runs on the whole global batch, in no group.
"""

import contextlib
import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from encodec_pytorch_tpu_torch.models.model import EncodecModel  # noqa: E402
from encodec_pytorch_tpu_torch.models.msstftd import MultiScaleSTFTDiscriminator  # noqa: E402
from encodec_pytorch_tpu_torch.parallel import mesh  # noqa: E402
from encodec_pytorch_tpu_torch.quantization import vq as vq_module  # noqa: E402
from encodec_pytorch_tpu_torch.train.balancer import Balancer  # noqa: E402
from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step  # noqa: E402

# tiny widths (n_filters 4, n_q 4, tensor_cut 4800) and two SEANet stages
# (ratios 8, 2: 300 frames an item), so that a step's global microbatch has
# 1200 rows, more than the 1024 bins: the k-means seeds and the expiry rows are
# a permutation's prefix, as at full width (12 x 225 rows). Bandwidths 30 and
# 60 kbps are n_q 2 and 4 at the 1500 Hz frame rate. 10 k-means iterations
# (tests/test_torch_train.py's RVQ test; the quantizer's default is 50).
TINY = dict(target_bandwidths=[30., 60.], sample_rate=24000, channels=1, causal=True,
            model_norm='weight_norm', audio_normalize=True, n_q=4, n_filters=4, ratios=(8, 2))
DISC = dict(filters=4, n_ffts=(256,), hop_lengths=(64,), win_lengths=(256,))
WEIGHTS = {'l_t': 0.1, 'l_f': 1, 'l_g': 3, 'l_feat': 3}
KMEANS_ITERS = 10
LENGTH = 4800


def modules(seed: int = 8):
    """The port's seeded init of the generator and the discriminator."""
    gen = torch.Generator().manual_seed(seed)
    model = EncodecModel._get_model(generator=gen, **TINY)
    model.quantizer.kmeans_iters = KMEANS_ITERS
    return model, MultiScaleSTFTDiscriminator(generator=gen, **DISC)


def global_batch(seed: int, size: int = 4, nan_rows=()) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((size, 1, LENGTH)).astype(np.float32) * 0.1
    x[list(nan_rows)] = np.nan
    return x


def state(model, disc, opts, balancer) -> Dict[str, torch.Tensor]:
    """Every tensor of the training state by name, in the layout of
    ``convert.train_state_from_jax`` (``model/``, ``disc/``, ``adam_g/``,
    ``adam_d/``, ``balancer/``), cloned."""
    out = {f'model/{k}': v for k, v in model.state_dict().items()}
    out.update({f'disc/{k}': v for k, v in disc.state_dict().items()})
    for name, opt, module in (('adam_g', opts[0], model), ('adam_d', opts[1], disc)):
        for pname, p in module.named_parameters():
            for k, v in opt.state.get(p, {}).items():
                out[f'{name}/{k}/{pname}'] = v
    for name in ('total', 'fix'):
        out.update({f'balancer/{name}/{k}': v for k, v in getattr(balancer, name).items()})
    return {k: v.detach().clone() for k, v in out.items()}


@contextlib.contextmanager
def recording_codes():
    """Collects the codes ``[K, B, T]`` of every RVQ training forward inside."""
    real, codes = vq_module.rvq_forward, []

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        codes.append(out[1].clone())
        return out

    vq_module.rvq_forward = record
    try:
        yield codes
    finally:
        vq_module.rvq_forward = real


def run(scenario: dict, dp: Optional[mesh.DataParallel] = None) -> dict:
    """The scenario's steps from the seeded init: on the global batch, or
    under ``dp`` on this rank's rows of it. ``scenario``: ``batch`` (the
    global batch size), ``accum``, ``seed`` (of the RVQ's generator, unless a
    step gives ``draws``) and ``steps``,
    each with ``n_q``, ``train_disc``, ``lr``, ``batch_seed`` and optionally
    ``nan_rows``, ``draws`` and ``skip_nonfinite``. Returns the state after
    each step, the metrics and each microbatch's codes."""
    model, disc = modules()
    balancer = Balancer(WEIGHTS)
    opts = (make_optimizer(model.parameters()), make_optimizer(disc.parameters()))
    gen = torch.Generator().manual_seed(scenario['seed'])
    out: Dict[str, List] = {'states': [], 'metrics': [], 'codes': []}
    for step in scenario['steps']:
        x = torch.from_numpy(global_batch(step['batch_seed'], scenario['batch'],
                                          step.get('nan_rows', ())))
        if dp is not None:
            rows = scenario['batch'] // dp.world
            x = x[dp.rank * rows:(dp.rank + 1) * rows]
        with recording_codes() as codes:
            metrics = train_step(model, disc, balancer, *opts, x, n_q=step['n_q'],
                                 train_disc=step['train_disc'], lr_g=step['lr'],
                                 lr_d=step['lr'], sample_rate=24000, generator=gen,
                                 draws=step.get('draws'), grad_accum_steps=scenario['accum'],
                                 skip_nonfinite=step.get('skip_nonfinite', False), dp=dp)
        out['states'].append(state(model, disc, opts, balancer))
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        out['codes'].append(codes)
        if dp is not None:
            mesh.assert_replicated(dp, list(out['states'][-1].values()))
    if dp is not None:      # the guard's AND: rank 0 alone is finite
        out['all_finite'] = bool(dp.all_(torch.tensor(dp.rank == 0)))
    return out


def launch(spec_path: str, out_prefix: str, world: int = 2) -> List[subprocess.Popen]:
    """Start ``world`` rank subprocesses on the scenarios saved at ``spec_path``
    (one on the global batch when ``world`` is 1); rank r saves its results
    to ``{out_prefix}{r}.pt``."""
    init = f'file://{out_prefix}rendezvous'
    env = dict(os.environ, OMP_NUM_THREADS='1')
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                              init, spec_path, f'{out_prefix}{r}.pt'], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def main(argv) -> int:
    rank, world, init, spec_path, out_path = argv
    torch.set_num_threads(1)
    dp = mesh.initialize_distributed('cpu', init, int(rank), int(world)) if int(world) > 1 else None
    try:
        spec = torch.load(spec_path, weights_only=True)
        torch.save({name: run(scenario, dp) for name, scenario in spec.items()}, out_path)
    finally:
        if dp is not None:
            dp.close()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
