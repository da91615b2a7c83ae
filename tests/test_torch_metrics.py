"""The port's objective metrics, its ``cal_metrics`` CLI and its dataset prep
CLI on the CPU, against the JAX package, on seeded signals and files.

- ``si_snr`` and ``stoi`` (and extended STOI) within 1e-6 absolute of the JAX
  functions; ``mel_distance`` (the port's on ``device='cpu'``) within 1e-5
  relative of the JAX one; ``pesq_score`` and ``visqol_score`` return None
  here (neither package is installed), and ``mel_distance`` refuses the card
  where there is none;
- ``cal_metrics.main`` on a reference/decoded directory pair (``_bw``
  suffixes, a decoded file without a reference) writes the per-file lines the
  JAX CLI writes, character for character (values at 4 decimals), and returns
  their means;
- ``prep generate``, ``merge`` and ``durations`` give the JAX functions' rows.
"""

import csv

import numpy as np
import pandas as pd
import pytest
import torch

from encodec_pytorch_tpu import cal_metrics as jax_cal
from encodec_pytorch_tpu import metrics as jax_metrics
from encodec_pytorch_tpu.data import prep as jax_prep
from encodec_pytorch_tpu_torch import cal_metrics, metrics
from encodec_pytorch_tpu_torch.data import prep
from encodec_pytorch_tpu_torch.utils import write_wav


def _pair(seed: int, seconds: float = 1.0, sr: int = 24000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
    ref = envelope * sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(150, 3000, 4))
    ref = (ref + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    est = (0.8 * ref + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    return ref, est


@pytest.mark.parametrize('seed', [0, 1])
def test_metrics_equal_jax(seed, monkeypatch):
    ref, est = _pair(seed)
    assert abs(metrics.si_snr(ref, est) - jax_metrics.si_snr(ref, est)) <= 1e-6
    for extended in (False, True):
        got = metrics.stoi(ref, est, 24000, extended=extended)
        assert abs(got - jax_metrics.stoi(ref, est, 24000, extended=extended)) <= 1e-6
    assert 0.0 < metrics.stoi(ref, est, 24000) < 1.0
    got, want = (metrics.mel_distance(ref, est, 24000, device='cpu'),
                 jax_metrics.mel_distance(ref, est, 24000))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert metrics.pesq_score(ref, est, 24000) is None
    assert metrics.visqol_score(ref, est, 24000) is None
    with pytest.raises(ValueError, match='mode'):
        metrics.pesq_score(ref, est, 24000, mode='xx')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        metrics.mel_distance(ref, est, 24000)


def test_cal_metrics_equals_the_jax_cli(tmp_path, capsys):
    ref_dir, deg_dir = tmp_path / 'ref', tmp_path / 'deg'
    for i in range(2):
        ref, est = _pair(10 + i)
        write_wav(ref_dir / f'clip{i}.wav', ref[None], 24000)
        write_wav(deg_dir / f'clip{i}_bw1.5.wav', est[None], 24000)
    write_wav(deg_dir / 'orphan_bw6.0.wav', est[None], 24000)
    means = cal_metrics.main(['-r', str(ref_dir), '-d', str(deg_dir), '-o',
                              str(tmp_path / 'ours.txt'), '--device', 'cpu'])
    assert 'no reference for' in capsys.readouterr().out
    jax_cal.main(['-r', str(ref_dir), '-d', str(deg_dir), '-o', str(tmp_path / 'ref.txt')])
    ours = (tmp_path / 'ours.txt').read_text()
    assert ours == (tmp_path / 'ref.txt').read_text()
    lines = ours.splitlines()
    assert len(lines) == 2 and all(line.startswith(f'file=clip{i}_bw1.5.wav')
                                   for i, line in enumerate(lines))
    values = [dict(kv.split('=') for kv in line.split('  ')) for line in lines]
    assert set(means) == {'si_snr', 'mel_dist', 'stoi'}
    for k, v in means.items():
        assert abs(v - np.mean([float(d[k]) for d in values])) <= 1e-4


def test_prep_rows_equal_jax(tmp_path):
    tree = tmp_path / 'tree'
    rng = np.random.default_rng(3)
    for i in range(7):
        write_wav(tree / f'spk{i % 3}' / f'utt{i}.wav',
                  rng.uniform(-0.5, 0.5, (1, 2400 + 600 * i)).astype(np.float32), 24000)
    (tree / 'notes.txt').write_text('not audio')

    def rows(path):
        with open(path, newline='') as f:
            return [r for r in csv.reader(f) if r]

    ours = prep.generate_csv(str(tree), str(tmp_path / 'ours'), split=0.7)
    ref = jax_prep.generate_csv(str(tree), str(tmp_path / 'ref'), split=0.7)
    for a, b in zip(ours, ref):
        assert rows(a) == rows(b) and rows(a)
    assert len(rows(ours[0])) == 4 and len(rows(ours[1])) == 3
    prep.merge_csv(list(ours), str(tmp_path / 'ours_all.csv'))
    jax_prep.merge_csv(list(ref), str(tmp_path / 'ref_all.csv'))
    assert rows(tmp_path / 'ours_all.csv') == rows(tmp_path / 'ref_all.csv')
    prep.main(['durations', str(tmp_path / 'ours_all.csv'), '-o', str(tmp_path / 'd_ours.csv')])
    jax_prep.collect_audio_durations(str(tmp_path / 'ref_all.csv'), str(tmp_path / 'd_ref.csv'))
    got, want = rows(tmp_path / 'd_ours.csv'), pd.read_csv(tmp_path / 'd_ref.csv')
    assert got[0] == list(want.columns) == ['filename', 'duration']
    assert [r[0] for r in got[1:]] == list(want['filename'])
    assert [float(r[1]) for r in got[1:]] == list(want['duration'])
