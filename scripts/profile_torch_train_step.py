#!/usr/bin/env python3
"""Profile the PyTorch port's GAN training step on one NVIDIA GPU.

    python3 scripts/profile_torch_train_step.py [--config NAME] [--seed N] [--steps 2] [--out DIR]
        [key.path=value ...]

Builds the port's trainer at the full width of a default set, as
``chip_smoke.py`` does, with any config overrides given (e.g.
``tpu.compute_dtype=float32``): ``--config config`` (the default;
``encodec_pytorch_tpu/configs/config.yaml``: bf16, batch 12 x 72000 mono, the
discriminator's eligible convs on kernel K4, 36 synthetic 3 s clips) or
``--config config_48k_stereo`` (f32, batch 32 x 48000 stereo, the F-stride-2
convs' forward on kernel K5, 96 synthetic 1.25 s clips); runs two warm-up steps
(k-means init, cuDNN autotune), then traces ``--steps`` steps with
``torch.profiler`` (CPU and CUDA). Each step draws the config's largest n_q
(24 kbps) and trains the discriminator, so the traced steps do the most work
a step can do. It prints:

- the wall time of each traced step (host clock, ending in a synchronize),
  the device's busy time (sum of kernel times) and its idle share;
- device time by kernel, largest first;
- the port's own kernels by name (K4, K5, their weight packing, each in f32
  and bf16, K2's forward): device time a step and share of the device's busy
  time;
- for the ``record_function`` ranges that this script wraps around K4's
  forward and dx wrappers, K5's forward wrapper, K2's forward and K2's
  backward (the plain recurrence recomputed and differentiated): the device
  time of the ATen kernels inside each (the port's kernels, launched through
  ctypes, are not attributed to a range: they count above) and its extent on
  the device timeline (idle gaps between launches included);
- device time of the other kernels grouped by name: cuDNN convolutions,
  GEMMs, and the rest;

and with ``--trace`` writes the chrome trace to ``--out`` (default
``build/profile/``, which git ignores). Needs a CUDA card; exits non-zero without one.
"""

import argparse
import collections
import contextlib
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--config', default='config', choices=('config', 'config_48k_stereo'),
                        help="the port's default set to train at full width")
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--steps', type=int, default=2)
    parser.add_argument('--out', default=str(ROOT / 'build' / 'profile'))
    parser.add_argument('--trace', action='store_true', help='write the chrome trace')
    parser.add_argument('overrides', nargs='*', help='key.path=value config overrides')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_torch_train_step: no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import (disc_conv_kernel, disc_im2col_kernel, lstm,
                                               lstm_kernel)
    from encodec_pytorch_tpu_torch.train.step import train_step
    from encodec_pytorch_tpu_torch.train.trainer import Trainer

    print(f'device: {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}', flush=True)
    ranges = {}

    def labelled(label, fn):
        ranges[label] = None

        def wrapper(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        wrapper.launches = 0    # the wrapped kernel entry counts under its module name
        return wrapper

    disc_conv_kernel.disc_conv_forward = labelled('K4 forward', disc_conv_kernel.disc_conv_forward)
    disc_conv_kernel.disc_conv_input_grad = labelled('K4 dx',
                                                     disc_conv_kernel.disc_conv_input_grad)
    disc_im2col_kernel.disc_im2col_forward = labelled('K5 forward',
                                                      disc_im2col_kernel.disc_im2col_forward)
    lstm_kernel.lstm_recurrence = labelled('K2 forward', lstm_kernel.lstm_recurrence)
    lstm._Recurrence.backward = staticmethod(labelled('K2 backward (plain recurrence)',
                                                      lstm._Recurrence.backward))

    with tempfile.TemporaryDirectory() as tmp:
        overrides = chip_smoke.train_overrides(Path(tmp), args.seed, args.config) + list(
            args.overrides)
        trainer = Trainer(load_config(overrides, name=args.config), 'cuda')
        config = trainer.config
        sr, channels = int(config.model.sample_rate), int(config.model.channels)
        batch = torch.from_numpy(chip_smoke.make_clip(
            args.seed + 9, int(config.datasets.batch_size), trainer.tensor_cut / sr, sr,
            channels)).cuda()
        n_q = max(trainer.n_q_table)
        print(f'{args.config} {args.overrides}: batch {tuple(batch.shape)}, n_q {n_q}, '
              f'{trainer.model.encoder.dtype}', flush=True)

        def step():
            t0 = time.perf_counter()
            train_step(trainer.model, trainer.disc, trainer.balancer, trainer.opt_g,
                       trainer.opt_d, batch, n_q=n_q, train_disc=True, lr_g=3e-4, lr_d=3e-4,
                       sample_rate=sr, generator=trainer.device_gen)
            torch.cuda.synchronize()
            return 1000 * (time.perf_counter() - t0)

        for _ in range(2):
            step()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            walls = [step() for _ in range(args.steps)]

    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    wall = sum(walls) / len(walls)
    print(f'step wall ms {[round(w, 1) for w in walls]}; device busy {busy:.1f} ms a step; '
          f'idle share {1 - busy / wall:.3f}')
    print('device ms a step by kernel (largest first):')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:30]:
        print(f'  {e.self_device_time_total / 1e3 / args.steps:9.3f} ms  {e.count // args.steps:6d}x'
              f'  {e.key[:110]}')
    own = {'K4 (disc_conv_kernel)': 'disc_conv_kernel',
           'K4 bf16 (disc_conv_bf16_kernel<...>)': 'disc_conv_bf16_kernel<',
           'K5 (disc_im2col_kernel)': 'disc_im2col_kernel',
           'K5 bf16 (disc_im2col_bf16_kernel)': 'disc_im2col_bf16_kernel',
           'weight packing of K4 and K5 (pack_weight_kernel)': 'pack_weight_kernel',
           'K4 bf16 weight packing (disc_conv_bf16_pack_kernel)': 'disc_conv_bf16_pack_kernel',
           'K5 bf16 weight packing (pack_weight_bf16_kernel)': 'pack_weight_bf16_kernel',
           'K2 forward (lstm_recurrence_kernel)': 'lstm_recurrence_kernel'}
    for label, name in own.items():
        ms = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 / args.steps
        launches = sum(e.count for e in kernels if name in e.key) // args.steps
        print(f'{label}: {ms:.3f} ms a step in {launches} launches ({ms / busy:.3f} of the '
              f'busy time)')
    # a range shows twice: on the host (device_time_total = its kernels' time)
    # and on the device timeline (first kernel to last, idle gaps included)
    for label in ranges:
        host = [e for e in events if e.key == label and e.device_type != cuda]
        span = [e for e in events if e.key == label and e.device_type == cuda]
        kern = host[0].device_time_total / 1e3 / args.steps if host else float('nan')
        extent = span[0].self_device_time_total / 1e3 / args.steps if span else float('nan')
        print(f'range {label}: ATen kernels {kern:.1f} ms a step, device-timeline extent '
              f'{extent:.1f} ms a step')
    groups = collections.OrderedDict((k, 0.0) for k in ('cuDNN conv', 'GEMM', 'other'))
    for e in kernels:
        name = e.key.lower()
        if any(s in name for s in own.values()):
            continue
        if any(s in name for s in ('conv', 'cudnn', 'xmma', 'implicit', 'wgrad', 'dgrad')):
            key = 'cuDNN conv'
        elif any(s in name for s in ('gemm', 'cutlass', 'ampere', 'sm90')):
            key = 'GEMM'
        else:
            key = 'other'
        groups[key] += e.self_device_time_total / 1e3 / args.steps
    print('device ms a step of the other kernels: '
          + ', '.join(f'{k} {v:.1f}' for k, v in groups.items())
          + ' (the K2-backward range holds GEMM and elementwise kernels counted here too)')
    if not args.trace:
        return 0
    Path(args.out).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(args.out) / 'torch_train_step_trace.json'))
    print(f'trace: {Path(args.out) / "torch_train_step_trace.json"}')
    return 0


if __name__ == '__main__':
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
