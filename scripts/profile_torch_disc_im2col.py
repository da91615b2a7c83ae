#!/usr/bin/env python3
"""Kernel K5 (the discriminator's F-stride-2 conv) under sustained load on one
NVIDIA GPU: time, SM clock and power at each of the 9 conv shapes of a 48 kHz
discriminator call.

    python3 scripts/profile_torch_disc_im2col.py [--seed N] [--seconds 2]

For each shape (x ``[32, 32, T, F]`` of the 48 kHz training config, seeded
normal inputs and weights) and each of K5's launch alone, K4's forward and
cuDNN's ``F.conv2d`` (TF32 off), it launches the conv back to back for about
``--seconds`` while ``nvidia-smi`` samples the SM clock and the power draw
every 50 ms, and prints the mean milliseconds a launch (CUDA events around
the loop), the achieved TFLOP/s (the conv's operations, not the three TF32
products), the median SM clock and power over the loop, and the card's name
and power limit. It says whether a kernel runs at the card's clock or below
it under its own power draw. Needs a CUDA card; exits non-zero without one.
"""

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (T, F, T dilation) of conv_1..conv_3 at each scale (n_fft 1024, 2048, 512)
SHAPES = [(184, 513, 1), (184, 257, 2), (184, 129, 4), (90, 1025, 1), (90, 513, 2),
          (90, 257, 4), (372, 257, 1), (372, 129, 2), (372, 65, 4)]


def sustained(fn, seconds: float):
    """(ms a launch, median SM MHz, median W) of ``fn`` run back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        fn()
    end.record()
    end.synchronize()
    n = max(10, int(seconds * 1e3 / max(start.elapsed_time(end) / 5, 1e-3)))
    smi = subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
                            '--format=csv,noheader,nounits', '-lms', '50'],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [line.split(',') for line in out.strip().splitlines()[1:] if ',' in line]
    clocks = [float(c) for c, _ in samples] or [float('nan')]
    power = [float(p) for _, p in samples] or [float('nan')]
    return start.elapsed_time(end) / n, statistics.median(clocks), statistics.median(power)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--seconds', type=float, default=2.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_torch_disc_im2col: no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'device: {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    totals = {}
    for T, F_, dt in SHAPES:
        x = torch.randn(32, 32, T, F_, generator=gen, device='cuda')
        w = torch.randn(32, 32, 3, 9, generator=gen, device='cuda') / 30
        b = torch.randn(32, generator=gen, device='cuda')
        geo = ((dt, 1), (dt, 4))
        wk = k5.pack_weight_cuda(w)
        Fo = (F_ - 1) // 2 + 1
        flops = 2.0 * 32 * T * Fo * 32 * 27 * 32
        line = f'x (32, 32, {T}, {F_}) dt {dt}, {flops / 1e9:.1f} GFLOP:'
        for name, fn in (('K5', lambda: k5.forward_packed(x, wk, b, *geo)),
                         ('K4 forward', lambda: dck.disc_conv_forward(x, w, b, k5.STRIDE, *geo)),
                         ('cuDNN', lambda: F.conv2d(x, w, b, k5.STRIDE, geo[1], geo[0]))):
            ms, mhz, watts = sustained(fn, args.seconds)
            totals[name] = totals.get(name, 0.0) + ms
            line += (f' {name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, SM {mhz:.0f} MHz, '
                     f'{watts:.1f} W);')
        print(line, flush=True)
        del x
    print('over the 9 convs: ' + ', '.join(f'{k} {v:.3f} ms' for k, v in totals.items()))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
