#!/usr/bin/env python3
"""Kernel K4 in bf16 (the discriminator's 32-channel convs, forward and input
gradient) at the shapes of one bf16 discriminator call of each training
config, on one NVIDIA GPU: where a wrapper call's time goes.

    python3 scripts/profile_torch_disc_conv_bf16.py [--seed N] [--before DIR]

The shapes are those of ``chip_smoke.py``'s K4 bf16 phase: at 24 kHz (the
default set, bf16, B 12 x 72000) the 12 eligible convs, forward and dx; at
48 kHz (``config_48k_stereo`` in bf16, B 32 x 48000 stereo) conv_4's 3
forwards and the 12 convs' dx. For each, by CUDA events: a wrapper call alone
(``wrapper``, what ``chip_smoke.py`` reports), 20 calls back to back
(``queued``, the host's launch cost hidden behind the card), the device
time of a call (``device``: ``chip_smoke.device_ms``, 20 calls queued
behind a sleeping kernel), the host's own time a call
(``host``: 20 calls enqueued behind a sleeping kernel, by the host clock),
and cuDNN in bf16 (``F.conv2d``, ``conv2d_input``). With ``--before DIR``
(another checkout of the port, e.g. the parent commit unpacked with ``git
archive``), that checkout's K4 bf16 runs on the same inputs in turns (parent,
this tree, this tree, parent) and the share of bit-equal outputs is printed.
Totals over both calls come last, then the card's name and power limit.
Needs a CUDA card; exits non-zero without one.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

RUNS = 20


def queued_ms(fn, runs: int = RUNS) -> float:
    """Mean ms a call over ``runs`` calls enqueued back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def host_ms(fn, runs: int = RUNS) -> float:
    """Median host ms a call, enqueued behind a sleeping kernel so that no
    call waits for the card."""
    times = []
    for _ in range(3):
        torch.cuda._sleep(200_000_000)
        start = time.perf_counter()
        for _ in range(runs):
            fn()
        times.append((time.perf_counter() - start) * 1e3 / runs)
        torch.cuda.synchronize()
    return statistics.median(times)


def measure(fn) -> dict:
    device = chip_smoke.device_ms(torch, fn)
    return dict(wrapper=chip_smoke.cuda_ms(torch, fn), queued=queued_ms(fn),
                device=float('nan') if device is None else device, host=host_ms(fn))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--before', type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import _build
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    _build.load()
    for line in _build.BuildInfo.log.splitlines():
        if 'disc_conv' in line or 'registers' in line or 'spill' in line:
            print(f'  ptxas: {line.strip()}')
    before = None
    if args.before is not None:
        before = chip_smoke.load_before(args.before).disc_conv_kernel
        chip_smoke.load_before(args.before)._build.load()
    smi = chip_smoke.nvidia_smi_line()
    gen = torch.Generator(device='cuda').manual_seed(args.seed + 30)
    rows, tot = [], {}
    for name, overrides in (('config', []), ('config_48k_stereo', ['tpu.compute_dtype=bfloat16'])):
        config = load_config(overrides, name=name)
        calls = chip_smoke.record_disc_convs(
            torch, config, args.seed, args.seed + 31,
            lambda m: getattr(m, 'uses_kernel', False) or getattr(m, 'uses_im2col', False))
        for x, w, b, m in calls:
            geo = (m.stride, m.dilation, m.padding)
            y = dck.disc_conv_forward_reference(x, w, b, *geo)
            g = torch.randn(y.shape, generator=gen, device='cuda').to(torch.bfloat16)
            K = w.shape[1] * w.shape[2] * w.shape[3]
            flops = 2.0 * y.numel() * K
            for p in (('fwd',) if m.uses_kernel else ()) + ('dx',):
                if p == 'fwd':
                    fns = {'kernel': lambda mod=dck: mod.disc_conv_forward_bf16(x, w, b, *geo),
                           'cudnn': lambda: F.conv2d(x, w, b, stride=m.stride,
                                                     padding=m.padding, dilation=m.dilation)}
                    if before is not None:
                        fns['before'] = lambda: before.disc_conv_forward_bf16(x, w, b, *geo)
                    nbytes = 2.0 * (x.numel() + w.numel() + b.numel() + y.numel())
                else:
                    fns = {'kernel': lambda: dck.disc_conv_input_grad_bf16(g, w, x.shape, *geo),
                           'cudnn': lambda: torch.nn.grad.conv2d_input(
                               x.shape, w, g, stride=m.stride, padding=m.padding,
                               dilation=m.dilation)}
                    if before is not None:
                        fns['before'] = lambda: before.disc_conv_input_grad_bf16(
                            g, w, x.shape, *geo)
                    nbytes = 2.0 * (g.numel() + w.numel() + x.numel())
                row = dict(config=name, p=p, x=list(x.shape), dilation=list(m.dilation),
                           gflop=flops / 1e9,
                           bound=chip_smoke.bound_ms(flops, nbytes,
                                                     chip_smoke.PEAK_BF16_FLOPS)[0])
                order = ['before', 'kernel', 'kernel', 'before'] if before else ['kernel']
                seen = {}
                for key in order:
                    got = measure(fns[key])
                    seen.setdefault(key, []).append(got)
                for key, runs in seen.items():
                    row[key] = {k: statistics.mean(r[k] for r in runs) for k in runs[0]}
                row['cudnn'] = {'wrapper': chip_smoke.cuda_ms(torch, fns['cudnn']),
                                'queued': queued_ms(fns['cudnn'])}
                if before is not None:
                    new, old = fns['kernel'](), fns['before']()
                    row['equal_to_before'] = float((new.view(torch.int16)
                                                    == old.view(torch.int16)).float().mean())
                k = row['kernel']
                print(f"{name} {p} x {tuple(x.shape)} dt {m.dilation[0]} {row['gflop']:.2f} GFLOP: "
                      f"wrapper {k['wrapper']:.4f} queued {k['queued']:.4f} device "
                      f"{k['device']:.4f} host {k['host']:.4f} ms; "
                      f"cuDNN {row['cudnn']['wrapper']:.4f}"
                      f" (queued {row['cudnn']['queued']:.4f}); bound {row['bound']:.4f}"
                      + (f"; before wrapper {row['before']['wrapper']:.4f} device "
                         f"{row['before']['device']:.4f} host {row['before']['host']:.4f}, "
                         f"bit-equal {row['equal_to_before']:.6f}" if before else ''), flush=True)
                rows.append(row)
                t = tot.setdefault(p, {})
                for key in ('kernel', 'before', 'cudnn'):
                    for k2, v in row.get(key, {}).items():
                        t[f'{key}_{k2}'] = t.get(f'{key}_{k2}', 0.0) + v
                t['bound'] = t.get('bound', 0.0) + row['bound']
                t['gflop'] = t.get('gflop', 0.0) + row['gflop']
                t['n'] = t.get('n', 0) + 1
    for p, t in tot.items():
        print(f'total {p} ({t["n"]} convs, {t["gflop"]:.1f} GFLOP): '
              + ', '.join(f'{k} {v:.3f}' for k, v in t.items() if k not in ('n', 'gflop')))
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
