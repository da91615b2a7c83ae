"""Objective evaluation CLI: score a directory of decoded wavs against their
references.

    python -m encodec_pytorch_tpu_torch.cal_metrics -r ref_dir -d deg_dir [-s 24000] [-o scores.txt] [--visqol] [--device cuda|cpu]

Port of ``encodec_pytorch_tpu/cal_metrics.py``. Each ``*.wav`` under the
decoded directory is matched to the reference of the same name less its
``_bw{n}`` suffix (the compression CLI's), and scored by STOI, SI-SNR and mel
distance (the last on the card unless ``--device cpu``), plus NB/WB PESQ and
ViSQOL where those packages are installed. Prints a line a file and the means,
and with ``-o`` writes the per-file lines to a text file.
"""

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .data.audio_io import read_wav
from .metrics import mel_distance, pesq_score, si_snr, stoi, visqol_score


def get_parser():
    parser = argparse.ArgumentParser('cal_metrics')
    parser.add_argument('-r', '--ref_dir', type=Path, required=True,
                        help='directory of reference (ground-truth) wavs')
    parser.add_argument('-d', '--deg_dir', type=Path, required=True,
                        help='directory of degraded/decoded wavs')
    parser.add_argument('-s', '--sample_rate', type=int, default=24000)
    parser.add_argument('-o', '--output', type=Path, default=None,
                        help='write per-file scores to this txt file')
    parser.add_argument('--visqol', action='store_true',
                        help='also compute ViSQOL MOS-LQO if available')
    parser.add_argument('--device', default='cuda',
                        help='where the mel distance runs: cuda (default) or cpu')
    return parser


def match_reference(deg_path: Path, ref_dir: Path) -> Path:
    """The reference of a decoded file: its name less the ``_bw{n}`` suffix."""
    stem = deg_path.stem
    if '_bw' in stem:
        stem = stem[:stem.rindex('_bw')]
    return ref_dir / f'{stem}{deg_path.suffix}'


def main(argv=None):
    parser = get_parser()
    args = parser.parse_args(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        parser.error('no CUDA device is available; pass --device cpu to score on the CPU')
    scores = defaultdict(list)
    lines = []
    for deg in sorted(args.deg_dir.rglob('*.wav')):
        ref = match_reference(deg, args.ref_dir)
        if not ref.exists():
            print(f'no reference for {deg}, skipping')
            continue
        x, sr_x = read_wav(ref)
        y, _ = read_wav(deg)
        x, y = x.reshape(-1), y.reshape(-1)
        entry = {'file': deg.name}
        entry['si_snr'] = si_snr(x, y)
        entry['mel_dist'] = mel_distance(x, y, args.sample_rate, device=args.device)
        try:
            entry['stoi'] = stoi(x, y, sr_x)
        except ValueError as exc:
            print(f'stoi failed for {deg}: {exc}')
        nb = pesq_score(x, y, sr_x, 'nb')
        if nb is not None:
            entry['pesq_nb'] = nb
            entry['pesq_wb'] = pesq_score(x, y, sr_x, 'wb')
        if args.visqol:
            v = visqol_score(x, y, sr_x)
            if v is not None:
                entry['visqol'] = v
        for k, v in entry.items():
            if k != 'file':
                scores[k].append(v)
        line = '  '.join(f'{k}={v:.4f}' if isinstance(v, float) else f'{k}={v}'
                         for k, v in entry.items())
        lines.append(line)
        print(line)

    print('\n==== means ====')
    for k, vals in scores.items():
        print(f'mean {k}: {np.mean(vals):.4f}  (n={len(vals)})')
    if args.output:
        args.output.write_text('\n'.join(lines) + '\n')
    return {k: float(np.mean(v)) for k, v in scores.items()}


if __name__ == '__main__':
    main()
