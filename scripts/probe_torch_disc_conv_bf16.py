#!/usr/bin/env python3
"""Where kernel K4's bf16 form spends its time, on one NVIDIA GPU: variants of
``csrc/disc_conv_bf16.cu`` built side by side with one part taken out, and
one with ``clock64`` stamps around each step of the producer's and the
consumers' loops.

    python3 scripts/probe_torch_disc_conv_bf16.py

The variants are made from the source by text edits (the script fails if an
edit no longer applies) and built with nvcc into ``build/probe/``:

- ``base``: the kernel as it is;
- ``no_copy``: the producers copy and lay out nothing (the consumers compute
  on whatever the stages hold), so the products, the handshakes and the
  epilogue are left;
- ``no_mma``: the consumers issue no wgmma, so the copies, the layout, the
  handshakes and the epilogue are left;
- ``handshake``: neither, only the mbarrier handshakes and the epilogue;
- ``stamps``: the kernel with ``clock64`` stamps, reporting per chunk (8
  summed channels of a tile) the producer's cycles issuing its copies,
  waiting for them, laying the chunk out and waiting for a free stage, and
  the consumers' cycles waiting for a laid-out stage, and per tile their
  epilogue's.

Each runs the forward and the input gradient of three convs of the 24 kHz
discriminator call (B 12; conv_1 at n_fft 1024, dilation 1; conv_3,
dilation 4; conv_4, 3x3), timed by CUDA events over 20 calls (weights packed
each call, as the wrappers do). The outputs of the variants but ``base`` and
``stamps`` are wrong by construction. Needs a CUDA card and nvcc.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from encodec_pytorch_tpu_torch.ops import _build  # noqa: E402
from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck  # noqa: E402

SRC = ROOT / 'encodec_pytorch_tpu_torch' / 'csrc' / 'disc_conv_bf16.cu'
OUT = ROOT / 'build' / 'probe'
SHAPES = [(12, 278, 513, 1, (3, 9)), (12, 278, 129, 4, (3, 9)), (12, 278, 65, 1, (3, 3))]

PRODUCER_LOOP = '''        for (int i = 0; i < total; ++i) {
            if (i + 1 < total) issue(i + 1);
            else cp_async_commit();
            cp_async_wait<1>();
            producer_sync();                 // every producer's copies of chunk i are in
            const int st = i % NP;
            mbar_wait(&empty[st], ((i / NP) & 1) ^ 1);
            load_weights(i);
            layout(i);
            fence_proxy_async();
            __syncwarp();
            if ((pt & 31) == 0) mbar_arrive(&full[st]);
            producer_sync();                 // raw stage i % NR is free for chunk i + NR
        }'''
PRODUCER_STAMPED = '''        unsigned long long tt[4] = {0, 0, 0, 0};
        for (int i = 0; i < total; ++i) {
            const long long c0 = clock64();
            if (i + 1 < total) issue(i + 1);
            else cp_async_commit();
            const long long c1 = clock64();
            cp_async_wait<1>();
            producer_sync();
            const long long c2 = clock64();
            const int st = i % NP;
            mbar_wait(&empty[st], ((i / NP) & 1) ^ 1);
            const long long c3 = clock64();
            load_weights(i);
            layout(i);
            fence_proxy_async();
            __syncwarp();
            if ((pt & 31) == 0) mbar_arrive(&full[st]);
            producer_sync();
            const long long c4 = clock64();
            tt[0] += c1 - c0; tt[1] += c2 - c1; tt[2] += c3 - c2; tt[3] += c4 - c3;
        }
        if (pt == 0) {
            for (int q = 0; q < 4; ++q) atomicAdd(&g_stamps[q], tt[q]);
            atomicAdd(&g_stamps[7], (unsigned long long)total);
        }'''


def variant(name: str) -> str:
    s = SRC.read_text()

    def edit(old: str, new: str) -> None:
        nonlocal s
        if old not in s:
            raise SystemExit(f'{name}: the source changed; this edit no longer applies:\n{old}')
        s = s.replace(old, new)

    if name in ('no_copy', 'handshake'):
        edit('        if (total > 0) issue(0);',
             '        auto issue = [&](int) { cp_async_commit(); };\n'
             '        if (total > 0) issue(0);')
        edit('            layout(i);\n', '')
        s = s.replace('        auto issue = [&](int i) {',
                      '        auto issue_unused = [&](int i) {', 1)
    if name in ('no_mma', 'handshake'):
        edit('            mma_step<L, P, 0>(acc, a16, b16, dtws, chunk == 0);\n', '')
    if name == 'stamps':
        edit('#include "tma.cuh"\n',
             '#include "tma.cuh"\n__device__ unsigned long long g_stamps[8];\n')
        edit(PRODUCER_LOOP, PRODUCER_STAMPED)
        edit('            mbar_wait(&full[st], (i / NP) & 1);',
             '            const long long d0 = clock64();\n'
             '            mbar_wait(&full[st], (i / NP) & 1);\n'
             '            wait_full += clock64() - d0;')
        edit('    for (int k = 0, i = 0; k < my_tiles; ++k) {',
             '    unsigned long long wait_full = 0, epilogue = 0;\n'
             '    for (int k = 0, i = 0; k < my_tiles; ++k) {')
        edit('        consumer_sync();                     // the previous tile\'s rows are out',
             '        const long long d1 = clock64();\n        consumer_sync();')
        edit('        staged = tile_at<L::QC>(g, blockIdx.x + k * gridDim.x);',
             '        epilogue += clock64() - d1;\n'
             '        staged = tile_at<L::QC>(g, blockIdx.x + k * gridDim.x);')
        edit('    if (my_tiles > 0) store_rows(0, n_o);\n}',
             '    if (my_tiles > 0) store_rows(0, n_o);\n'
             '    if (tid == 0) {\n'
             '        atomicAdd(&g_stamps[4], wait_full);\n'
             '        atomicAdd(&g_stamps[5], epilogue);\n'
             '        atomicAdd(&g_stamps[6], (unsigned long long)my_tiles);\n'
             '    }\n}')
        s += ('\nextern "C" int encodec_probe_stamps(unsigned long long* out) {\n'
              '    cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n'
              '    unsigned long long zero[8] = {0};\n'
              '    return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));\n}\n')
    return s


def build(names):
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / 'tma.cuh').write_text((SRC.parent / 'tma.cuh').read_text())
    procs = []
    for name in names:
        src = OUT / f'disc_conv_bf16_{name}.cu'
        src.write_text(variant(name))
        lib = OUT / f'libprobe_{name}.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed\n{log}')
        handle = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.encodec_disc_conv_fwd_bf16.argtypes = [p] * 4 + [i] * 12 + [p]
        handle.encodec_disc_conv_dx_bf16.argtypes = [p] * 3 + [i] * 12 + [p]
        libs[name] = handle
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    names = ('base', 'no_copy', 'no_mma', 'handshake', 'stamps')
    libs = build(names)
    gen = torch.Generator(device='cuda').manual_seed(0)
    bf = torch.bfloat16
    for B, T, F, dt, (KT, KF) in SHAPES:
        sf, pf = (2, 4) if KF == 9 else (1, 1)
        x = torch.randn(B, 32, T, F, generator=gen, device='cuda').to(bf)
        w = (torch.randn(32, 32, KT, KF, generator=gen, device='cuda') / 30).to(bf)
        y = dck.disc_conv_forward_reference(x, w, None, (1, sf), (dt, 1), (dt, pf))
        gy = torch.randn(y.shape, generator=gen, device='cuda').to(bf)
        for p in ('fwd', 'dx'):
            out = torch.empty_like(y if p == 'fwd' else x)
            stream = torch.cuda.current_stream().cuda_stream
            line = [f'{p} x {(B, 32, T, F)} dt {dt} {KT}x{KF}:']
            for name, lib in libs.items():
                def run():
                    wk = dck.pack_weight_cuda(w, sf, p == 'dx')
                    if p == 'fwd':
                        rc = lib.encodec_disc_conv_fwd_bf16(
                            x.data_ptr(), wk.data_ptr(), None, out.data_ptr(), B, 32, 32, T, F,
                            KT, KF, sf, dt, dt, pf, 0, stream)
                    else:
                        rc = lib.encodec_disc_conv_dx_bf16(
                            gy.data_ptr(), wk.data_ptr(), out.data_ptr(), B, 32, 32, T, F, KT,
                            KF, sf, dt, dt, pf, 0, stream)
                    if rc:
                        raise RuntimeError(f'{name}: CUDA error {rc}')
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run()
                end.record()
                end.synchronize()
                line.append(f'{name} {start.elapsed_time(end) / 20:.4f} ms')
                if name == 'stamps':
                    stamps = (ctypes.c_ulonglong * 8)()
                    lib.encodec_probe_stamps(stamps)
                    run()
                    torch.cuda.synchronize()
                    lib.encodec_probe_stamps(stamps)
                    n, tiles = max(stamps[7], 1), max(stamps[6], 1)
                    line.append(
                        f'(cycles a chunk: producer copy issue {stamps[0] / n:.0f}, copy wait '
                        f'{stamps[1] / n:.0f}, free-stage wait {stamps[2] / n:.0f}, layout '
                        f'{stamps[3] / n:.0f}; consumers\' wait for a stage {stamps[4] / n:.0f}; '
                        f'epilogue a tile {stamps[5] / tiles:.0f})')
            print(' '.join(line), flush=True)
    proc = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True)
    print(proc.stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
