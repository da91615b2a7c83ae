"""The port's trainer data-parallel on the CPU (mirrors
tests/test_multihost_trainer.py): ``train_cli`` in 2 processes started with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` on localhost), over gloo.

- An uncut run of one epoch (2 steps of a global batch of 4, 2 rows a rank):
  each rank trained on its own shard (disjoint indices), the ranks' states
  equal (checksums of every tensor), exactly one checkpoint and one
  tensorboard run (rank 0's), the reconstruction demo written, a log file a
  rank, rank 1's ending in ``_p1``.
- A run where rank 1 alone gets SIGTERM after its first step: both ranks stop
  after that step with exit code 143, and there is exactly one ``_preempt``
  checkpoint and no epoch checkpoint.
- Both ranks resume from that file and finish the epoch: their state equals
  the uncut run's bit for bit.

Each rank is a subprocess with a 120 s timeout.
"""

import glob
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

from encodec_pytorch_tpu_torch.utils import write_wav

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120

# a rank: train_cli with argv[3:], SIGTERM to itself after step argv[2] when it
# is rank 1 (0: never); writes its exit code, steps, shard and state checksums
_CHILD = textwrap.dedent('''
    import json, os, signal, sys
    sys.path.insert(0, %r)
    import torch
    torch.set_num_threads(1)
    from encodec_pytorch_tpu_torch import train_cli
    from encodec_pytorch_tpu_torch.parallel import replica_checksums
    from encodec_pytorch_tpu_torch.train import trainer as trainer_module

    out, cut_after = sys.argv[1], int(sys.argv[2])
    real, taken, made = trainer_module.train_step, [], []
    real_init = trainer_module.Trainer.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        made.append(self)

    def step(*args, **kwargs):
        metrics = real(*args, **kwargs)
        taken.append(1)
        if len(taken) == cut_after and os.environ['RANK'] == '1':
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    trainer_module.train_step, trainer_module.Trainer.__init__ = step, init
    try:
        train_cli.main(sys.argv[3:])
        code = 0
    except SystemExit as e:
        code = e.code
    trainer = made[0]
    json.dump(dict(code=code, steps=trainer.step, indices=trainer.trainloader._indices(),
                   device=str(trainer.device), world=trainer.world,
                   checksums=replica_checksums(trainer.replicated_tensors()).tolist()),
              open(out, 'w'))
    sys.exit(code)
''' % _repo)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start(tmp, name, overrides, cut_after=0):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE='2', LOCAL_RANK=str(rank),
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port), OMP_NUM_THREADS='1')
        procs.append(subprocess.Popen(
            [sys.executable, '-c', _CHILD, str(tmp / f'{name}{rank}.json'), str(cut_after),
             '--device', 'cpu', *overrides, f'checkpoint.save_folder={tmp / name}/'],
            env=env, cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _finish(tmp, name, procs):
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:        # a rank left waiting for a failed one
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        path = tmp / f'{name}{rank}.json'
        assert path.exists(), (name, rank, p.returncode, out[-2000:], err[-4000:])
        results.append(json.loads(path.read_text()))
        assert results[-1]['code'] == p.returncode, (name, rank, err[-4000:])
    return results


def test_two_rank_trainer_sharded_cut_by_sigterm_and_resumed(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(12):
        paths.append(str(tmp_path / f'clip{i}.wav'))
        t = np.arange(3600) / 24000
        wav = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.05 * rng.standard_normal(t.size)
        write_wav(paths[-1], wav[None].astype(np.float32), 24000)
    (tmp_path / 'train.csv').write_text('\n'.join(paths[:8]) + '\n')
    (tmp_path / 'test.csv').write_text('\n'.join(paths[8:]) + '\n')
    overrides = [f'datasets.train_csv_path={tmp_path / "train.csv"}',
                 f'datasets.test_csv_path={tmp_path / "test.csv"}', 'datasets.batch_size=4',
                 'datasets.tensor_cut=2400', 'common.max_epoch=1', 'common.save_interval=1',
                 'common.log_interval=1', 'lr_scheduler.warmup_epoch=0', 'model.n_q=2',
                 'model.n_filters=4', 'model.filters=4', 'model.disc_n_ffts=[256]',
                 'model.disc_hop_lengths=[64]', 'model.disc_win_lengths=[256]',
                 'tpu.compute_dtype=float32']
    uncut_ranks = _start(tmp_path, 'uncut', overrides)
    cut_ranks = _start(tmp_path, 'cut', overrides, cut_after=1)
    uncut = _finish(tmp_path, 'uncut', uncut_ranks)
    cut = _finish(tmp_path, 'cut', cut_ranks)

    # the uncut run: 2 steps on disjoint shards, replicated state, rank-0 artifacts
    assert [r['code'] for r in uncut] == [0, 0] and [r['steps'] for r in uncut] == [2, 2]
    assert [r['world'] for r in uncut] == [2, 2] and uncut[0]['device'] == 'cpu'
    assert not set(uncut[0]['indices']) & set(uncut[1]['indices'])
    assert sorted(uncut[0]['indices'] + uncut[1]['indices']) == list(range(8))
    assert uncut[0]['checksums'] == uncut[1]['checksums']
    folder = tmp_path / 'uncut'
    assert [os.path.basename(p) for p in glob.glob(f'{folder}/*.ckpt')] == [
        'bs4_cut2400_length0_epoch1_lr0.0003.ckpt']
    assert (folder / 'GT.wav').exists() and (folder / 'Reconstruction.wav').exists()
    assert len(glob.glob(f'{folder}/runs/events.out.tfevents.*')) == 1
    logs = sorted(os.path.basename(p) for p in glob.glob(f'{folder}/train_encodec_*.log'))
    assert logs == ['train_encodec_bs4_lr0.0003.log', 'train_encodec_bs4_lr0.0003_p1.log']
    assert 'Epoch 1 2/2' in (folder / logs[0]).read_text()

    # SIGTERM to rank 1 alone: both stop after step 1, one _preempt file
    assert [r['code'] for r in cut] == [143, 143] and [r['steps'] for r in cut] == [1, 1]
    preempt = glob.glob(f'{tmp_path}/cut/*.ckpt')
    assert [os.path.basename(p) for p in preempt] == ['bs4_cut2400_length0_epoch0_preempt_'
                                                     'lr0.0003.ckpt']

    # both ranks resume from it and end where the uncut run ended, bit for bit
    resumed = _finish(tmp_path, 'cut', _start(
        tmp_path, 'cut', overrides + ['checkpoint.resume=True',
                                      f'checkpoint.checkpoint_path={preempt[0]}']))
    assert [r['code'] for r in resumed] == [0, 0] and [r['steps'] for r in resumed] == [2, 2]
    assert resumed[0]['checksums'] == resumed[1]['checksums'] == uncut[0]['checksums']
