#!/usr/bin/env python3
"""How far kernels K4 (the discriminator's f32 convs, forward and input
gradient, 3xTF32 on the tensor cores) and K5 (its F-stride-2 convs' forward
at 48 kHz, 3xTF32 by wgmma) and cuDNN in f32 sit from float64, per conv and
through a training step's discriminator gradients, on one NVIDIA GPU.

    python3 scripts/probe_torch_disc_conv_accuracy.py [--seed N] [--before DIR]
        [--variants [NAME ...]] [--no-trained]

Per conv: the 12 eligible convs of one discriminator call of ``config`` (B 12
x 72000), of ``config_mono_nq2`` (B 16 x 24000) and of ``config_48k_stereo``
(B 32 x 48000, stereo), seeded weights and a seeded clip
(``chip_smoke.record_disc_convs``), and a seeded gradient for the input
gradient; K5 at the 9 F-stride-2 convs of the 48 kHz call. Each output against ``F.conv2d`` / ``conv2d_input`` in
float64: the largest difference over the largest reference value, the
relative norm of the difference, and the mean signed error toward the
reference's sign over its mean magnitude (below 0: the outputs shrink). Then
the medians of a call by CUDA events over both calls' convs.

Through a step (unless ``--no-trained``): ``config_mono_nq2`` at full width
trained as ``chip_smoke.py``'s mono nq2 phase trains it (3 steps, then 3 more
resumed through ``config_mono_nq2_resume``); from that state, the
discriminator's hinge loss on a seeded real batch and the model's output, and
its parameters' gradients, and the gradient of ``l_g + l_feat`` with respect
to that output, each against the same computed in float64 by ``F.conv2d``.

With ``--before DIR`` (another checkout of the port, e.g. the parent commit
unpacked with ``git archive``) that checkout's K4 and K5 are measured beside
this tree's on the same inputs, and timed in turns (this tree, before,
before, this tree). With ``--variants`` the same holds for forms of K4 and
K5 made from this tree's sources by text edits (``VARIANTS``; the script
fails if an edit no longer applies), each copied with the package into
``build/variants/<name>/`` and built there: where the three products of a
k-step are summed (into the running sum, or from zero over 1, 2 or all k-steps
of a chunk, then one rounding add) and how many blocks an SM the kernel is
built for. The card's name and power limit come last. Needs a CUDA card.
"""

import argparse
import contextlib
import copy
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


CSRC = ROOT / 'encodec_pytorch_tpu_torch' / 'csrc'

# K4: the k-step's three products from zero, then one rounding add (the form
# in the tree), and the loop's end, where a grouped form adds its sums
K4_STEP = '''                        float part[4] = {0.f, 0.f, 0.f, 0.f};
                        mma_tf32(part, al, bh[n][0], bh[n][1]);
                        mma_tf32(part, ah, bl[n][0], bl[n][1]);
                        mma_tf32(part, ah, bh[n][0], bh[n][1]);
#pragma unroll
                        for (int i = 0; i < 4; ++i) acc[f][n][i] += part[i];
'''
K4_RUNNING = '''                        mma_tf32(acc[f][n], al, bh[n][0], bh[n][1]);
                        mma_tf32(acc[f][n], ah, bl[n][0], bl[n][1]);
                        mma_tf32(acc[f][n], ah, bh[n][0], bh[n][1]);
'''
K4_GROUPED = '''                        mma_tf32(part[f][n], al, bh[n][0], bh[n][1]);
                        mma_tf32(part[f][n], ah, bl[n][0], bl[n][1]);
                        mma_tf32(part[f][n], ah, bh[n][0], bh[n][1]);
'''
K4_S_END = '''            }
        }
    }
    if (!live) return;
'''
K4_FLUSH = '''            }
            if ((s + 1) % GROUP == 0 || s + 1 == P::NS) {
#pragma unroll
                for (int f = 0; f < 4; ++f)
#pragma unroll
                    for (int n = 0; n < 4; ++n)
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            acc[f][n][i] += part[f][n][i];
                            part[f][n][i] = 0.f;
                        }
            }
        }
    }
    if (!live) return;
'''
K4_BOUNDS = '__launch_bounds__(THREADS, 2)\ndisc_conv_kernel('
K5_BOUNDS = '__launch_bounds__(THREADS, 2)\ndisc_im2col_kernel('
# K5: each group's three products from zero into one of two partial sums (the
# form in the tree), the add of the group before last's sum, the part sums
# and the chunk's end
K5_STEP = '''                wgmma_tf32<0>(part[n & 1], l, d_hi);
                wgmma_tf32<1>(part[n & 1], h, d_lo);
                wgmma_tf32<1>(part[n & 1], h, d_hi);
'''
K5_ADD = '''                if (n >= 2) {
#pragma unroll
                    for (int i = 0; i < 16; ++i) acc[(n - 2) % NT][i] += part[n & 1][i];
                }
'''
K5_PART = '    float part[2][16] = {};        // two groups\' partial sums in flight\n'
K5_DESC = '        const uint64_t dbase = b_desc(wbuf + (k & 1) * WCHUNK);\n'
K5_END = '''        constexpr int last = NSTEP * NT - 1;   // the chunk's last two groups
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            acc[(last - 1) % NT][i] += part[(last - 1) & 1][i];
            acc[last % NT][i] += part[last & 1][i];
        }
'''


def _k4_grouped(group: int):
    part = ('    float part[4][4][4];\n#pragma unroll\n    for (int f = 0; f < 4; ++f)\n'
            '#pragma unroll\n        for (int n = 0; n < 4; ++n)\n#pragma unroll\n'
            '            for (int i = 0; i < 4; ++i) part[f][n][i] = 0.f;\n')
    return [(K4_STEP, K4_GROUPED), (K4_S_END, K4_FLUSH.replace('GROUP', str(group))),
            ('    float acc[4][4][4];\n', '    float acc[4][4][4];\n' + part)]


def _k5_running():
    """Every group's products summed onto its tile's running sum."""
    return [(K5_STEP, K5_STEP.replace('<0>', '<1>').replace('part[n & 1]', 'acc[j]')),
            (K5_ADD, ''), (K5_END, ''), (K5_PART, '')]


def _k5_chunk():
    """A chunk's products (14 k-steps) summed from zero into a partial sum a
    tile, added to the running sums at the chunk's end."""
    zero = ('#pragma unroll\n        for (int j = 0; j < NT; ++j)\n#pragma unroll\n'
            '            for (int i = 0; i < 16; ++i) part[j][i] = 0.f;\n')
    add = ('#pragma unroll\n        for (int j = 0; j < NT; ++j)\n#pragma unroll\n'
           '            for (int i = 0; i < 16; ++i) acc[j][i] += part[j][i];\n')
    return [(K5_STEP, K5_STEP.replace('<0>', '<1>').replace('part[n & 1]', 'part[j]')),
            (K5_ADD, ''), (K5_END, add), (K5_PART, '    float part[NT][16];\n'),
            (K5_DESC, K5_DESC + zero)]


ONE_BLOCK_K4 = (K4_BOUNDS, K4_BOUNDS.replace('2)', '1)'))
ONE_BLOCK_K5 = (K5_BOUNDS, K5_BOUNDS.replace('2)', '1)'))
# name: (kernel, source, [(text, replacement), ...]); each text must occur,
# and only its first occurrence (the f32 kernel's) is replaced
VARIANTS = {
    'K4 running sum': ('K4', 'disc_conv.cu', [(K4_STEP, K4_RUNNING)]),
    'K4 from zero by 2 k-steps': ('K4', 'disc_conv.cu', _k4_grouped(2)),
    'K4 from zero by chunk': ('K4', 'disc_conv.cu', _k4_grouped(1000)),
    'K4 from zero by chunk, 1 block an SM': ('K4', 'disc_conv.cu',
                                             _k4_grouped(1000) + [ONE_BLOCK_K4]),
    'K5 running sum': ('K5', 'disc_im2col.cu', _k5_running()),
    'K5 from zero by k-step, 1 block an SM': ('K5', 'disc_im2col.cu', [ONE_BLOCK_K5]),
    'K5 from zero by chunk': ('K5', 'disc_im2col.cu', _k5_chunk()),
}


def make_variant(name: str) -> Path:
    """A copy of the package under ``build/variants/`` with one source edited."""
    _, source, edits = VARIANTS[name]
    tag = ''.join(c if c.isalnum() else '_' for c in name.lower())
    root = ROOT / 'build' / 'variants' / tag
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / 'encodec_pytorch_tpu_torch', root / 'encodec_pytorch_tpu_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    text = (CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f'variant {name!r}: an edit of {source} no longer applies')
        text = text.replace(old, new, 1)
    (root / 'encodec_pytorch_tpu_torch' / 'csrc' / source).write_text(text)
    return root


def ptxas_lines(log: str, kernel: str) -> list:
    """ptxas's register and spill lines for the entry points whose mangled
    name holds ``kernel`` (and not ``bf16``)."""
    out, keep = [], False
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            keep = kernel in line and 'bf16' not in line
            name = line.split("'")[1] if "'" in line else line
        elif keep and ('spill' in line or 'Used' in line):
            out.append(f'{name}: {line.split(":", 1)[-1].strip()}')
    return out


def errors(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |d| / max |ref|, |d| / |ref| by norm, mean signed error toward
    the reference's sign / mean |ref|), ``ref`` float64."""
    d = got.double() - ref
    return (float(d.abs().max() / ref.abs().max()),
            float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref)),
            float((d * ref.sign()).mean() / ref.abs().mean()))


def fmt(e: tuple) -> str:
    return f'{e[0]:.2e} of max, {e[1]:.2e} by norm, bias {e[2]:+.2e}'


def per_conv(seed: int, impls: dict) -> None:
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    times = {name: [] for name in impls}
    times['cuDNN'] = []
    for config_name in ('config', 'config_mono_nq2', 'config_48k_stereo'):
        config = load_config(['tpu.compute_dtype=float32'], name=config_name)
        calls = chip_smoke.record_disc_convs(
            torch, config, seed, seed + 7,
            lambda m: getattr(m, 'uses_kernel', False) or getattr(m, 'uses_im2col', False))
        gen = torch.Generator(device='cuda').manual_seed(seed + 8)
        for x, w, b, m in calls:
            geo = (m.stride, m.dilation, m.padding)
            y64 = F.conv2d(x.double(), w.double(), b.double(), stride=m.stride,
                           padding=m.padding, dilation=m.dilation)
            g = torch.randn(y64.shape, generator=gen, device='cuda')
            dx64 = torch.nn.grad.conv2d_input(x.shape, w.double(), g.double(), stride=m.stride,
                                              padding=m.padding, dilation=m.dilation)
            line = [f'{config_name} x {tuple(x.shape)} dilation {m.dilation} stride {m.stride}:']
            funcs = dict(impls, cuDNN=(dck.disc_conv_forward_reference,
                                       dck.disc_conv_input_grad_reference))
            for name, (fwd, dx) in funcs.items():
                line.append(f'{name} fwd {fmt(errors(fwd(x, w, b, *geo), y64))}; '
                            f'dx {fmt(errors(dx(g, w, x.shape, *geo), dx64))}')
            print(' | '.join(line), flush=True)
            # in turns: each K4 twice, cuDNN once, per conv
            order = list(impls) + list(reversed(impls))
            per = {name: [] for name in funcs}
            for name in order + ['cuDNN']:
                fwd, dx = funcs[name]
                per[name].append(chip_smoke.cuda_ms(torch, lambda: fwd(x, w, b, *geo))
                                 + chip_smoke.cuda_ms(torch, lambda: dx(g, w, x.shape, *geo)))
            for name, v in per.items():
                times[name].append(statistics.mean(v))
            del y64, dx64, g
    for name, v in times.items():
        print(f'{name}: forward + dx over the three discriminator calls {sum(v):.3f} ms '
              f'(24 kHz and mono nq2 {sum(v[:24]):.3f} ms; means of CUDA-event medians, '
              f'K4s in turns)', flush=True)


def k5_per_conv(seed: int, impls: dict) -> None:
    """K5's forward (and ``impls``' other forms) and cuDNN against float64 at
    the 9 F-stride-2 convs of one 48 kHz discriminator call, timed in turns."""
    from encodec_pytorch_tpu_torch.config import load_config
    calls = chip_smoke.record_disc_convs(torch, load_config(name='config_48k_stereo'), seed,
                                         seed + 17, lambda m: getattr(m, 'uses_im2col', False))
    funcs = dict(impls, cuDNN=lambda x, w, b, dilation, padding: F.conv2d(
        x, w, b, stride=(1, 2), padding=padding, dilation=dilation))
    times = {name: [] for name in funcs}
    for x, w, b, m in calls:
        geo = (m.dilation, m.padding)
        y64 = F.conv2d(x.double(), w.double(), b.double(), stride=(1, 2), padding=m.padding,
                       dilation=m.dilation)
        print(' | '.join([f'config_48k_stereo x {tuple(x.shape)} dilation {m.dilation}:']
                         + [f'{name} fwd {fmt(errors(fwd(x, w, b, *geo), y64))}'
                            for name, fwd in funcs.items()]), flush=True)
        per = {name: [] for name in funcs}
        for name in list(impls) + list(reversed(impls)) + ['cuDNN']:
            per[name].append(chip_smoke.cuda_ms(torch, lambda: funcs[name](x, w, b, *geo)))
        for name, v in per.items():
            times[name].append(statistics.mean(v))
        del y64
    for name, v in times.items():
        print(f'{name}: forward over the 9 convs {sum(v):.3f} ms (means of CUDA-event '
              f'medians, K5s in turns)', flush=True)


def disc64(disc, x):
    """The discriminator's forward in float64 by ``F.conv2d``."""
    from encodec_pytorch_tpu_torch.ops.stft import stft
    logits, fmaps = [], []
    for d in disc.discriminators:
        spec = stft(x, d.n_fft, d.hop_length, d.win_length, window=d.spec_transform.window,
                    normalized=True)
        z = torch.cat([spec.real, spec.imag], dim=1).transpose(2, 3)
        fm = []
        for layer in d.convs:
            z = F.leaky_relu(F.conv2d(z, layer.conv.kernel(), layer.conv.bias,
                                      stride=layer.stride, padding=layer.padding,
                                      dilation=layer.dilation), 0.2)
            fm.append(z)
        post = d.conv_post
        logits.append(F.conv2d(z, post.conv.kernel(), post.conv.bias, padding=post.padding))
        fmaps.append(fm)
    return logits, fmaps


def gradients(disc, real, fake, run):
    """(the discriminator's parameter gradients of its hinge loss, the
    gradient of l_g + l_feat with respect to ``fake``), flattened, float64."""
    from encodec_pytorch_tpu_torch.train.losses import disc_loss, gan_losses
    disc = copy.deepcopy(disc)
    fake = fake.clone().requires_grad_()
    logits_real, fmap_real = run(disc, real)
    logits_fake, fmap_fake = run(disc, fake)
    params = list(disc.parameters())
    gp = torch.autograd.grad(disc_loss(logits_real, logits_fake), params, retain_graph=True)
    losses = gan_losses([[f.detach() for f in fm] for fm in fmap_real], logits_fake, fmap_fake)
    gx = torch.autograd.grad(losses['l_g'] + losses['l_feat'], fake)[0]
    return torch.cat([t.reshape(-1).double() for t in gp]), gx.reshape(-1).double()


def trained(seed: int, impls: dict) -> None:
    from encodec_pytorch_tpu_torch import train_cli
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        chip_smoke.write_scene_tree(tmp / 'scenes', seed + 13)
        common = [f'datasets.data_root={tmp / "scenes"}', f'checkpoint.save_folder={tmp}/ck/',
                  'common.log_interval=100', f'common.seed={seed}']
        first = train_cli.main(['--device', 'cuda', '--config', 'config_mono_nq2', *common,
                                *chip_smoke.MONO_NQ2_CUTS])
        ckpt = f'{first.config.checkpoint.save_location}epoch1_lr0.0003.ckpt'
        resumed = train_cli.main(['--device', 'cuda', '--config', 'config_mono_nq2_resume',
                                  *common, *chip_smoke.MONO_NQ2_CUTS,
                                  f'checkpoint.checkpoint_path={ckpt}', 'common.max_epoch=2'])
    real = torch.from_numpy(chip_smoke.make_clip(seed + 21, 16, 1.0)).cuda()
    for label, t in (('after 3 steps', first), ('after the resumed 3 more', resumed)):
        with torch.no_grad():
            fake, _ = copy.deepcopy(t.model).forward_train(
                real, 2, torch.Generator(device='cuda').manual_seed(seed))
        ref = gradients(copy.deepcopy(t.disc).double(), real.double(), fake.double(), disc64)
        saved = dck.disc_conv
        for name, conv in dict(impls, cuDNN=None).items():
            routes = contextlib.nullcontext() if conv is not None else chip_smoke.plain_path()
            if conv is not None:
                dck.disc_conv = conv
            try:
                with routes:
                    gp, gx = gradients(t.disc, real, fake, lambda d, x: d(x))
            finally:
                dck.disc_conv = saved
            print(f'mono nq2, {label}: {name}: discriminator gradients {rel(gp, ref[0]):.3e} '
                  f'from float64 by relative norm, d(l_g + l_feat)/d output '
                  f'{rel(gx, ref[1]):.3e}', flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--before', type=Path, default=None)
    parser.add_argument('--variants', nargs='*', default=None, choices=list(VARIANTS),
                        help='the variants to measure beside this tree (all if none is named)')
    parser.add_argument('--no-trained', action='store_true')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from encodec_pytorch_tpu_torch.ops import _build
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
    _build.load()
    impls = {'K4': (dck.disc_conv_forward, dck.disc_conv_input_grad)}
    convs = {'K4': dck.disc_conv}
    k5_impls = {'K5': k5.disc_im2col_forward}
    others = {}
    if args.before is not None:
        others['before'] = ('both', args.before)
    if args.variants is not None:
        others.update((name, (VARIANTS[name][0], make_variant(name)))
                      for name in args.variants or VARIANTS)
    for line in ptxas_lines(_build.BuildInfo.log, 'disc_conv_kernel') + \
            ptxas_lines(_build.BuildInfo.log, 'disc_im2col_kernel'):
        print(f'this tree: {line}', flush=True)
    for i, (name, (kernel, path)) in enumerate(others.items()):
        ops = chip_smoke.load_before(path, f'probe_port_{i}')
        try:
            ops._build.load()
        except RuntimeError as e:   # a variant that does not build is reported and left out
            print(f'{name}: does not build: {str(e)[-2000:]}', flush=True)
            continue
        for line in ptxas_lines(ops._build.BuildInfo.log, 'disc_conv_kernel') + \
                ptxas_lines(ops._build.BuildInfo.log, 'disc_im2col_kernel'):
            print(f'{name}: {line}', flush=True)
        if kernel in ('both', 'K4'):
            label = 'K4 before' if kernel == 'both' else name
            impls[label] = (ops.disc_conv_kernel.disc_conv_forward,
                            ops.disc_conv_kernel.disc_conv_input_grad)
            convs[label] = ops.disc_conv_kernel.disc_conv
        if kernel in ('both', 'K5'):
            k5_impls['K5 before' if kernel == 'both' else name] = \
                ops.disc_im2col_kernel.disc_im2col_forward
    per_conv(args.seed, impls)
    k5_per_conv(args.seed, k5_impls)
    if not args.no_trained:
        trained(args.seed, convs)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
