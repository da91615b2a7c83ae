#!/usr/bin/env python3
"""Where kernel K5's bf16 form (``csrc/disc_im2col_bf16.cu``) spends its
time, on one NVIDIA GPU: the kernel built with its ``clock64`` stamps on,
and two variants with one side taken out.

    python3 scripts/probe_torch_disc_im2col_bf16.py [--batch N] [--runs N] [--variants]

The variants are the source built with macros (``K5_STAMPS``,
``K5_NO_MMA``, ``K5_NO_COPY``) by nvcc into ``build/probe/``; the library
the port loads has none of them:

- ``stamps``: the kernel as it is, with stamps. Per chunk (8 input channels
  of a tile), the producers' cycles waiting for a free stage and laying the
  chunk out (the funnel shifts, the stmatrix stores, the next chunk's loads
  issued between them, and the handshake), from warp 0 of the producers of
  each CTA; the consumers' (thread 0) waiting for a laid-out stage, issuing
  the chunk's 56 wgmmas, storing the previous tile's share of rows and
  waiting for the group before; per tile their epilogue, and the cycles of
  a CTA's loop per tile;
- ``no_mma``: the consumers issue no wgmma, so the loads, the layout, the
  handshakes and the epilogue are left;
- ``no_copy``: the producers load nothing (they store zeros), so the
  products, the handshakes and the epilogue are left.

With ``--variants``, forms of the source made by text edits (the script
fails if an edit no longer applies) are also built and timed in turns
beside the library's kernel (library, the forms, then the same in reverse),
each held bit-equal to it: ``stages3`` and ``stages5`` (window stages),
``producers4`` and ``producers12`` (producer warps), ``lag1`` (consumer
warpgroup 1 starts a chunk behind warpgroup 0).

Each runs the 9 F-stride-2 convs of one bf16 48 kHz discriminator call
(B 32 stereo by default: T 184, 90, 372 frames; dilations 1, 2, 4), beside
the library's kernel (its entry called as the variants' are, into one
output, the weights packed once), timed by CUDA events (median of
``--runs`` launches). The outputs of ``no_mma`` and
``no_copy`` are wrong by construction; ``stamps`` is held bit-equal to the
library's. Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from encodec_pytorch_tpu_torch.ops import _build  # noqa: E402
from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5  # noqa: E402

SRC = ROOT / 'encodec_pytorch_tpu_torch' / 'csrc' / 'disc_im2col_bf16.cu'
OUT = ROOT / 'build' / 'probe'
# (T, F, dilation) of conv_1..conv_3 at the three scales of the 48 kHz call
SHAPES = [(184, 513, 1), (184, 257, 2), (184, 129, 4), (90, 1025, 1), (90, 513, 2),
          (90, 257, 4), (372, 257, 1), (372, 129, 2), (372, 65, 4)]
VARIANTS = {'stamps': ['-DK5_STAMPS'], 'no_mma': ['-DK5_STAMPS', '-DK5_NO_MMA'],
            'no_copy': ['-DK5_STAMPS', '-DK5_NO_COPY']}
FORMS = {
    'stages3': [('constexpr int NP = 4;', 'constexpr int NP = 3;')],
    'stages5': [('constexpr int NP = 4;', 'constexpr int NP = 5;')],
    'producers4': [('constexpr int NPROD = 256;', 'constexpr int NPROD = 128;')],
    'producers12': [('constexpr int NPROD = 256;', 'constexpr int NPROD = 384;')],
    'lag1': [('    mbar_wait(wbar, 0);\n',
              '    mbar_wait(wbar, 0);\n    if (u == 1 && total > 1) mbar_wait(&full[1], 0);\n')],
}


def form(name: str, edits) -> Path:
    """The source with ``edits`` applied, written beside its header."""
    s = SRC.read_text()
    for old, new in edits:
        if old not in s:
            raise SystemExit(f'the source changed; this edit no longer applies:\n{old}')
        s = s.replace(old, new)
    path = OUT / f'form_{name}.cu'
    path.write_text(s)
    return path


def build(forms: bool):
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / 'tma.cuh').write_text((SRC.parent / 'tma.cuh').read_text())
    builds = [(name, defines, SRC) for name, defines in VARIANTS.items()]
    if forms:
        builds += [(name, [], form(name, edits)) for name, edits in FORMS.items()]
    procs = []
    for name, defines, src in builds:
        lib = OUT / f'libk5_bf16_{name}.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, '-shared', '-o', str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed\n{log}')
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'wgmma' in line:
                print(f'  ptxas ({name}): {line.strip()}')
        handle = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.encodec_disc_im2col_fwd_bf16.argtypes = [p] * 4 + [i] * 10 + [p]
        if name in VARIANTS:
            handle.encodec_k5_stamps.argtypes = [p]
        libs[name] = handle
    return libs


def events_ms(fn, runs: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--batch', type=int, default=32)
    parser.add_argument('--runs', type=int, default=20)
    parser.add_argument('--variants', action='store_true',
                        help='also time the text-edited forms in turns')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    library = _build.load()
    libs = build(args.variants)
    gen = torch.Generator(device='cuda').manual_seed(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    totals = {name: 0.0 for name in ('library', *libs)}
    if args.variants:
        totals['library in turns'] = 0.0
    for T, F, dt in SHAPES:
        x = torch.randn(args.batch, 32, T, F, generator=gen, device='cuda').to(bf)
        w = (torch.randn(32, 32, 3, 9, generator=gen, device='cuda') / 30).to(bf)
        b = torch.randn(32, generator=gen, device='cuda').to(bf)
        geo = ((dt, 1), (dt, 4))
        wk = k5.pack_weight_cuda(w)
        ref = k5.forward_packed(x, wk, b, *geo)
        out = torch.empty_like(ref)
        line = [f'x {(args.batch, 32, T, F)} dt {dt}:']

        def launcher(lib, name):
            def run():
                rc = lib.encodec_disc_im2col_fwd_bf16(
                    x.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(), args.batch, 32,
                    32, T, F, 3, 9, dt, dt, 4, ctypes.c_void_p(stream))
                if rc:
                    raise RuntimeError(f'{name}: CUDA error {rc}')
            return run
        lib_call = launcher(library, 'library')
        ms = events_ms(lib_call, args.runs)
        totals['library'] += ms
        line.append(f'library {ms:.4f} ms')
        for name in VARIANTS:
            lib = libs[name]
            run = launcher(lib, name)
            ms = events_ms(run, args.runs)
            totals[name] += ms
            stamps = (ctypes.c_ulonglong * 16)()
            lib.encodec_k5_stamps(stamps)          # set to 0
            run()
            torch.cuda.synchronize()
            lib.encodec_k5_stamps(stamps)
            chunks, tiles = max(stamps[3], 1), max(stamps[10], 1)
            line.append(
                f'{name} {ms:.4f} ms (cycles a chunk: producers wait for a free stage '
                f'{stamps[0] / chunks:.0f}, lay out (and load the next chunk) '
                f'{stamps[1] / chunks:.0f}; consumers wait for a stage {stamps[4] / chunks:.0f}, '
                f'issue {stamps[5] / chunks:.0f}, store rows {stamps[6] / chunks:.0f}, wait for '
                f'the group before {stamps[7] / chunks:.0f}; a tile: epilogue '
                f'{stamps[8] / tiles:.0f}, loop {stamps[9] / tiles:.0f}; {stamps[10]} tiles on '
                f'{stamps[11]} CTAs)')
            if name == 'stamps':
                line.append(f'bit-equal to the library: {torch.equal(out, ref)}')
        forms = [n for n in libs if n not in VARIANTS]
        if forms:                                  # in turns: library, forms, forms, library
            turns = {n: [] for n in ['library', *forms]}
            for n in ['library', *forms, *forms[::-1], 'library']:
                fn = lib_call if n == 'library' else launcher(libs[n], n)
                turns[n].append(events_ms(fn, args.runs))
                if n != 'library' and not torch.equal(out, ref):
                    raise SystemExit(f'{n} is not bit-equal to the library at x {x.shape}')
            line.append('in turns: ' + ', '.join(
                f'{n} {statistics.mean(v):.4f} ms' for n, v in turns.items()))
            for n in forms:
                totals[n] += statistics.mean(turns[n])
            totals['library in turns'] += statistics.mean(turns['library'])
        print(' '.join(line), flush=True)
    print('over the 9 convs: ' + ', '.join(f'{k} {v:.3f} ms' for k, v in totals.items()))
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
