"""Dataset preparation: train/test CSVs of an audio tree, CSV merges, an
offline resample of a tree, and a table (and plot) of durations.

    python -m encodec_pytorch_tpu_torch.data.prep generate --input_dir ~/LibriTTS \\
        --output_dir ./datasets --split 0.9
    python -m encodec_pytorch_tpu_torch.data.prep merge a.csv b.csv -o all.csv
    python -m encodec_pytorch_tpu_torch.data.prep resample --input_dir in --output_dir out \\
        --target_sr 24000
    python -m encodec_pytorch_tpu_torch.data.prep durations train.csv -o durations.csv [--plot]

Port of ``encodec_pytorch_tpu/data/prep.py``, with the same split, rows and
files. CSVs are written and read with the ``csv`` module (the JAX package uses
pandas, which the card's machine lacks); the plot needs matplotlib.
"""

import argparse
import csv
import os
import random
from typing import List, Sequence

import numpy as np

from .audio_io import read_wav, resample, wav_info, write_wav

AUDIO_EXTS = ('.wav', '.flac')


def collect_audio_files(input_dir: str) -> List[str]:
    """The ``.wav`` and ``.flac`` files under ``input_dir``, in walk order,
    sorted within each folder."""
    files = []
    for root, _, names in os.walk(input_dir):
        for name in sorted(names):
            if name.lower().endswith(AUDIO_EXTS):
                files.append(os.path.join(root, name))
    return files


def _write_rows(path: str, rows: Sequence[Sequence]) -> None:
    with open(path, 'w', newline='') as f:
        csv.writer(f, lineterminator='\n').writerows(rows)


def _read_paths(path: str) -> List[str]:
    with open(path, newline='') as f:
        return [row[0] for row in csv.reader(f) if row and row[0].strip()]


def generate_csv(input_dir: str, output_dir: str, split: float = 0.9, seed: int = 42):
    """``train.csv`` and ``test.csv`` in ``output_dir``: the tree's files
    shuffled by ``random.Random(seed)``, the first ``split`` of them to train.
    Returns both paths."""
    files = collect_audio_files(input_dir)
    random.Random(seed).shuffle(files)
    n_train = int(len(files) * split)
    os.makedirs(output_dir, exist_ok=True)
    train_csv = os.path.join(output_dir, 'train.csv')
    test_csv = os.path.join(output_dir, 'test.csv')
    _write_rows(train_csv, [[f] for f in files[:n_train]])
    _write_rows(test_csv, [[f] for f in files[n_train:]])
    return train_csv, test_csv


def merge_csv(inputs: Sequence[str], output: str) -> str:
    """The paths of ``inputs``, one after the other, in one CSV."""
    _write_rows(output, [[p] for path in inputs for p in _read_paths(path)])
    return output


def resample_tree(input_dir: str, output_dir: str, target_sr: int = 24000,
                  mono: bool = True) -> None:
    """Each file of the tree as a 16-bit wav at ``target_sr`` under
    ``output_dir`` (same relative path), down-mixed to mono unless ``mono``
    is False."""
    for src in collect_audio_files(input_dir):
        rel = os.path.relpath(src, input_dir)
        dst = os.path.join(output_dir, os.path.splitext(rel)[0] + '.wav')
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        wav, sr = read_wav(src)
        if mono and wav.shape[0] > 1:
            wav = wav.mean(axis=0, keepdims=True)
        write_wav(dst, resample(wav, sr, target_sr), target_sr)


def collect_audio_durations(csv_file: str, output_path: str = './audio_durations.csv') -> str:
    """A CSV of ``filename,duration`` (seconds) for the wavs listed in
    ``csv_file``."""
    rows = []
    for f in _read_paths(csv_file):
        sr, n, _ = wav_info(f)
        rows.append([f, n / sr])
    _write_rows(output_path, [['filename', 'duration']] + rows)
    return output_path


def plot_audio_durations(duration_csv: str, boundaries=(0.5, 0.9, 0.99),
                         output_filename: str = 'audio_durations.png') -> str:
    """A histogram of the durations in 1 s bins with a dashed line at each
    percentile of ``boundaries``, saved as ``output_filename``."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError('plot_audio_durations needs matplotlib, which is not '
                          'installed') from exc
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    with open(duration_csv, newline='') as f:
        durations = np.array([float(row['duration']) for row in csv.DictReader(f)])
    bins = np.arange(0, int(np.ceil(durations.max())) + 1, 1)
    plt.figure(figsize=(12, 5))
    counts, edges, _ = plt.hist(durations, bins=bins)
    plt.title('audio durations distribution')
    plt.xlabel('time(s)')
    plt.ylabel('nums')
    cum_counts = np.cumsum(counts)
    colors = ['r', 'g', 'b', 'm', 'c', 'y', 'k']
    for i, boundary in enumerate(boundaries):
        idx = np.where(cum_counts >= len(durations) * boundary)[0]
        if len(idx):
            plt.axvline(x=edges[idx[0]], color=colors[i % len(colors)],
                        linestyle='--', label=f'{int(boundary * 100)}%')
    plt.legend()
    plt.savefig(output_filename, dpi=200)
    plt.close()
    return output_filename


def main(argv=None):
    parser = argparse.ArgumentParser('prep')
    sub = parser.add_subparsers(dest='cmd', required=True)

    g = sub.add_parser('generate')
    g.add_argument('--input_dir', required=True)
    g.add_argument('--output_dir', required=True)
    g.add_argument('--split', type=float, default=0.9)

    m = sub.add_parser('merge')
    m.add_argument('inputs', nargs='+')
    m.add_argument('-o', '--output', required=True)

    r = sub.add_parser('resample')
    r.add_argument('--input_dir', required=True)
    r.add_argument('--output_dir', required=True)
    r.add_argument('--target_sr', type=int, default=24000)
    r.add_argument('--stereo', action='store_true')

    d = sub.add_parser('durations')
    d.add_argument('csv_file')
    d.add_argument('-o', '--output', default='./audio_durations.csv')
    d.add_argument('--plot', action='store_true')

    args = parser.parse_args(argv)
    if args.cmd == 'generate':
        print(generate_csv(args.input_dir, args.output_dir, args.split))
    elif args.cmd == 'merge':
        print(merge_csv(args.inputs, args.output))
    elif args.cmd == 'resample':
        resample_tree(args.input_dir, args.output_dir, args.target_sr, mono=not args.stereo)
    elif args.cmd == 'durations':
        out = collect_audio_durations(args.csv_file, args.output)
        print(out)
        if args.plot:
            print(plot_audio_durations(out))


if __name__ == '__main__':
    main()
