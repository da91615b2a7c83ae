#!/usr/bin/env python3
"""Data-parallel training of the PyTorch port over NCCL on the NVIDIA GPUs of one host.

    python3 -m torch.distributed.run --nproc_per_node N scripts/check_torch_ddp_nccl.py [--seed 0]

Each rank, one card (``cuda:LOCAL_RANK``), joins the launcher's NCCL group
(``parallel.mesh.initialize_distributed``). Two parts, both at the full width
of the shipped ``config`` (24 kHz, a global batch of 12 x 72000):

1. The step (``chip_smoke.dp_steps``): each rank on its 12 / N rows of a
   seeded global batch, ``chip_smoke.DP_STEPS`` (the k-means init of all 32
   stages and the dead-code expiry, then two discriminator updates) with
   deterministic algorithms, in bf16 and in f32, every collective timed by
   CUDA events on the step's stream; then rank 0 alone takes the same steps
   on the 12 rows while the others wait. The ranks' states must be equal bit
   for bit (``assert_replicated``, inside ``dp_steps``); the N-rank state is
   held to the one process's by group within ``REL`` (set for 4 ranks).
2. The trainer: ``train_cli`` under this launcher for one epoch of 2 steps
   (``chip_smoke.train_overrides``: 24 clips of 3 s and 12 test clips, each
   rank reading its own copy), then the ranks' states compared bit for bit,
   and rank 0's files: one checkpoint, the demo wavs, a log file a rank.

Rank 0 prints each rank's ms a step and ms in collectives, the differences
and the card's name and power limit, and every rank exits non-zero if a
check fails. Needs N CUDA cards (N > 1); without a launcher or a card it
exits 2.
"""

import argparse
import glob
import os
import shutil
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# 4 ranks of 3 rows against one process of 12, relative norm of the
# difference by group (as chip_smoke.py phase 20 groups it): 2-3x the
# readings of the first run (4 x NVIDIA H100 80GB HBM3, 700 W), which
# deterministic algorithms repeat. f32: parameters 6.86e-5, Adam 4.22e-5,
# balancer 7.69e-5, codebook buffers 7.58e-3, stage 0 3.43e-5; bf16: 4.27e-3,
# 8.81e-2, 0.124, 0.865 (no bound), stage 0 9.27e-2. At 3 rows a rank cuDNN
# rounds otherwise than at 6 (phase 20's 2 ranks), and the k-means and
# Adam's g / sqrt(v) at small |g| carry that further.
REL = {'bfloat16': {'parameters': 1e-2, 'adam': 0.2, 'balancer': 0.3, 'stage 0': 0.25},
       'float32': {'parameters': 2e-4, 'adam': 1.5e-4, 'balancer': 2.5e-4, 'codebooks': 2e-2,
                   'stage 0': 1e-4}}


def gathered(dp, values) -> torch.Tensor:
    """``[world, len(values)]`` float64 on the host: every rank's ``values``."""
    return dp.all_gather(torch.tensor(values, dtype=torch.float64)).cpu()


def step_part(dp, folder: Path, seed: int, smi: str) -> bool:
    import chip_smoke as cs
    from encodec_pytorch_tpu_torch.config import load_config

    config = load_config()
    B, length = int(config.datasets.batch_size), int(config.datasets.tensor_cut)
    if dp.rank == 0:
        torch.save({'seed': seed, 'batch': torch.from_numpy(
            cs.make_clip(seed + 70, B, length / cs.SR))}, folder / 'spec.pt')
    dp.barrier()
    ok = True
    for dtype in cs.DP_DTYPES:
        mine = cs.dp_steps(torch, folder, dtype, dp)
        times = gathered(dp, mine['ms'] + mine['collective_ms'])
        n = len(mine['ms'])
        single = cs.dp_steps(torch, folder, dtype) if dp.rank == 0 else None
        dp.barrier()
        if dp.rank != 0:
            continue
        for r in range(dp.world):
            ms, coll = times[r, :n].tolist(), times[r, n:].tolist()
            cs.log(f'{dtype}: rank {r} of {dp.world} ({mine["rows"]} of {B} rows x {length}) on '
                   f'{smi}, NCCL: ms per step {[round(t, 1) for t in ms]}, in collectives '
                   f'{[round(t, 1) for t in coll]} (CUDA events on the step\'s stream; share '
                   f'{[round(c / m, 3) for c, m in zip(coll, ms)]}; {mine["collectives"]} '
                   f'all-reduces a step)')
        cs.log(f'{dtype}: one process on the {B} rows: ms per step '
               f'{[round(t, 1) for t in single["ms"]]}')
        a, want = mine['state'], single['state']
        rel = {}
        for g in cs.DP_STATE_GROUPS:
            keys = [k for k in want if cs._dp_group(k) == g]
            rel[g] = cs._rel_norm(torch.cat([a[k].reshape(-1).double() for k in keys]),
                                  torch.cat([want[k].reshape(-1).double() for k in keys]))
        embed = lambda st, k: st[f'model/quantizer.vq.layers.{k}._codebook.embed'].double()
        rel['stage 0'] = cs._rel_norm(embed(a, 0), embed(want, 0))
        passed = all(rel[g] <= bar for g, bar in REL[dtype].items())
        cs.log(f'{dtype}: the {dp.world} ranks bit-equal ({len(a)} tensors, assert_replicated); '
               f'against one process on the global batch, relative norm of the difference '
               f'{rel} (bars {REL[dtype]}): {"passed" if passed else "FAILED"}; launches '
               f'of rank 0 {mine["launches"]}')
        ok = ok and passed
    return bool(gathered(dp, [float(ok)])[0, 0])


def trainer_part(dp, folder: Path, seed: int) -> bool:
    import chip_smoke as cs
    from encodec_pytorch_tpu_torch import train_cli
    from encodec_pytorch_tpu_torch.parallel import assert_replicated
    from encodec_pytorch_tpu_torch.train import trainer as trainer_module

    data = folder / f'data{dp.rank}'
    data.mkdir()
    overrides = cs.train_overrides(data, seed, batches=2)
    save = folder / 'train'
    # the trainer takes this handle (its collectives timed) and leaves the group open
    real, owned = trainer_module.initialize_distributed, dp.owned
    trainer_module.initialize_distributed, dp.owned = (lambda *args, **kwargs: dp), False
    try:
        c0 = dp.collective_ms()
        trainer = train_cli.main(['--device', 'cuda', *overrides, 'common.save_interval=1',
                                  f'checkpoint.save_folder={save}/'])
        coll = dp.collective_ms() - c0
    finally:
        trainer_module.initialize_distributed, dp.owned = real, owned
    assert_replicated(dp, trainer.replicated_tensors())
    ms = [t for h in trainer.history for t in h['step_ms']]
    times = gathered(dp, ms + [coll])
    if dp.rank != 0:
        return True
    ckpts = [os.path.basename(p) for p in glob.glob(f'{save}/*.ckpt')]
    logs = sorted(os.path.basename(p) for p in glob.glob(f'{save}/train_encodec_*.log'))
    demo = all((save / name).exists() for name in ('GT.wav', 'Reconstruction.wav'))
    for r in range(dp.world):
        cs.log(f'train_cli: rank {r} of {dp.world} on {trainer.device if r == 0 else "its card"}: '
               f'{len(ms)} steps of {trainer.trainloader.batch_size} rows of the global '
               f'{trainer.config.datasets.batch_size}, ms per step '
               f'{[round(t, 1) for t in times[r, :-1].tolist()]}, {times[r, -1]:.1f} ms in NCCL '
               f'collectives over the run (the steps and the step-boundary signal checks)')
    cs.log(f'train_cli: the ranks\' states bit-equal (assert_replicated, '
           f'{len(trainer.replicated_tensors())} tensors); rank 0\'s files: checkpoints {ckpts}, '
           f'demo wavs {demo}, logs {logs}')
    return (len(ms) == 2 and len(ckpts) == 1 and demo and len(logs) == dp.world
            and sum(name.endswith(f'_p{r}.log') for name in logs for r in range(1, dp.world))
            == dp.world - 1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available() or 'WORLD_SIZE' not in os.environ:
        print('check_torch_ddp_nccl: needs CUDA cards and a launcher '
              '(python3 -m torch.distributed.run --nproc_per_node N ...)', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from encodec_pytorch_tpu_torch.ops import _build
    from encodec_pytorch_tpu_torch.parallel import initialize_distributed, local_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dp = initialize_distributed(local_device('cuda'))
    dp.timed = True
    folder = ROOT / 'build' / 'ddp_nccl'
    try:
        smi = cs.nvidia_smi_line() if dp.rank == 0 else ''
        if dp.rank == 0:
            cs.log(f'{dp.world} ranks over {dp.backend}; {smi}; torch {torch.__version__}, '
                   f'CUDA {torch.version.cuda}')
            shutil.rmtree(folder, ignore_errors=True)
            folder.mkdir(parents=True)
            _build.load()           # once, before the other ranks load the library
        dp.barrier()
        _build.load()
        t0 = time.perf_counter()
        ok = step_part(dp, folder, args.seed, smi)
        if dp.rank == 0:
            cs.log(f'the step part took {time.perf_counter() - t0:.1f} s')
        ok = trainer_part(dp, folder, args.seed) and ok
        ok = bool(gathered(dp, [float(ok)]).min())
        if dp.rank == 0:
            cs.log('all checks passed' if ok else 'a check FAILED')
        return 0 if ok else 1
    finally:
        dp.close()


if __name__ == '__main__':
    sys.exit(main())
