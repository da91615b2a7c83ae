#!/usr/bin/env python3
"""Instruments for kernel K6 (the LM coder, ``csrc/lm_coder.cu``) on one
NVIDIA GPU, beside what ``tests/test_torch_cuda.py`` checks and
``chip_smoke.py`` times.

    python3 scripts/probe_torch_lm_coder.py [--seed N] [--out DIR]

It builds ``scripts/probe_torch_lm_coder.cu`` (K6 with its clock64 stamps
on, and three instruments) and reports: the branch-free quantization
against IEEE division on every float32 bit pattern (0 mismatches expected);
the cycles a link of a dependent chain of each kind of operation costs one
warp; the cycles from a stall-mode call's start to each of its coder's and
producers' steps at K 8 and 32; the host microseconds a decode call's parts
cost; and a short encode (``StreamingLmEncoder.push_frame``'s one step of K
8 at card 1024, and its flush) as K6's one launch against two (CDF pairs,
then the coder), in turns by CUDA events and on the device. Lines on
stdout, the numbers in ``probe_lm_coder.json`` and the instruments' SASS in
``k6_sass.txt`` under ``--out`` (``build/probe``). Needs a CUDA card and
nvcc.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from encodec_pytorch_tpu_torch.bitstream import native  # noqa: E402
from encodec_pytorch_tpu_torch.ops import _build  # noqa: E402
from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6  # noqa: E402


def case(rng, steps, K, card, alpha=0.25):
    pdfs = rng.dirichlet(np.full(card, alpha), size=(steps, K)).astype(np.float32)
    cum = np.cumsum(pdfs.astype(np.float64), -1)
    u = rng.random((steps, K, 1)) * cum[..., -1:]
    syms = np.minimum((cum < u).sum(-1), card - 1).astype(np.int32)
    return pdfs, syms


def host_bytes(pdfs, syms):
    enc = native.NativeAcEncoder(24)
    enc.push_batch(syms.reshape(-1), native.build_cdf_batch(pdfs.reshape(-1, pdfs.shape[-1])))
    return enc.finish()


def stream_tensor(data: bytes, steps, K, device):
    buf = np.zeros(k6.stream_bytes(k6.bits_capacity(steps * K)), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(buf).to(device)


def host_breakdown(K: int = 8, card: int = 1024, calls: int = 2000) -> dict:
    """Host microseconds a decode call's parts cost, each repeated ``calls``
    times with no sync: the checks, the stream lookup, slicing a step's
    views, the four data pointers, an empty launch through ctypes, and the
    whole wrapper call."""
    pdfs = torch.full((16, K, card), 1.0 / card, device='cuda')
    out = torch.zeros(16, K, dtype=torch.int32, device='cuda')
    state = k6.init_state('cuda')
    bits = torch.zeros(4096, dtype=torch.uint8, device='cuda')
    p1, s1 = pdfs[3:4], out[3:4]
    lib = _build.load()
    stream = k6._stream(0)
    parts = {
        'checks': lambda: k6._accepts(p1, s1, state, bits),
        'stream lookup': lambda: k6._stream(0),
        'two step views by slicing': lambda: (pdfs[3:4], out[3:4]),
        'four data pointers': lambda: (p1.data_ptr(), s1.data_ptr(), state.data_ptr(),
                                       bits.data_ptr()),
        'empty launch by ctypes': lambda: lib.encodec_lm_coder_floor(1, K, card, 0, stream),
        'wrapper call': lambda: k6.lm_coder(p1, s1, state, bits, True, 0),
    }
    out_us = {}
    for name, fn in parts.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out_us[name] = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
    return out_us


def stamps_library(out_dir: Path):
    """``scripts/probe_torch_lm_coder.cu`` (this tree's ``csrc/lm_coder.cu``
    with its stamps on, and the probe's kernels) built into ``build/probe/``
    (its SASS into ``out_dir / 'k6_sass.txt'``)."""
    out = ROOT / 'build' / 'probe' / 'libk6_probe.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(out),
           str(Path(__file__).with_suffix('.cu'))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    cs.check(proc.returncode == 0, f'nvcc failed: {proc.stderr}')
    cuobjdump = Path(_build._nvcc()).parent / 'cuobjdump'
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), '-sass', str(out)], capture_output=True, text=True)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / 'k6_sass.txt').write_text(sass.stdout + sass.stderr)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.encodec_lm_coder_f32.restype = i
    lib.encodec_lm_coder_f32.argtypes = [i, p, i, i, i, ctypes.c_float, p, p, p, ll, ll, i, p,
                                         i, p]
    lib.encodec_lm_coder_stamps.restype = i
    lib.encodec_lm_coder_stamps.argtypes = [p]
    lib.encodec_lm_coder_check_quantize.restype = i
    lib.encodec_lm_coder_check_quantize.argtypes = [ctypes.c_float, p, p]
    lib.encodec_lm_coder_latency.restype = i
    lib.encodec_lm_coder_latency.argtypes = [i, i, p]
    lib.encodec_lm_coder_encode_two.restype = i
    lib.encodec_lm_coder_encode_two.argtypes = [p, i, i, ctypes.c_float, p, p, p, ll, i, p, p]
    return lib


LATENCY_OPS = ('int add', '32x32->64 product', 'shared load', 'shuffle', 'ballot + popc',
               'stamp', 'clz', 'acquire load', 'uint64 product', 'float multiply',
               'add + uniform branch')


def latencies(lib) -> dict:
    """Cycles a link of a dependent chain of each kind of operation, one
    warp alone on an SM (the difference of chains of 2000 and 1000 links)."""
    out = {}
    for op, name in enumerate(LATENCY_OPS):
        cycles = []
        for iters in (1000, 2000):
            c = ctypes.c_longlong(0)
            cs.check(lib.encodec_lm_coder_latency(op, iters, ctypes.byref(c)) == 0,
                     'latency launch failed')
            cycles.append(c.value)
        out[name] = (cycles[1] - cycles[0]) / 1000
    return out


def check_quantize(lib) -> dict:
    """The kernels' branch-free quantization against the one with IEEE
    division (``__fdiv_rn``) on every float32 bit pattern, at the scales of
    cards 16, 1024 and 8192: the patterns that differ (0 expected)."""
    out = {}
    for card in (16, 1024, 8192):
        bad = ctypes.c_ulonglong(0)
        first = ctypes.c_uint(0)
        rc = lib.encodec_lm_coder_check_quantize(k6.cdf_scale(card), ctypes.byref(bad),
                                                 ctypes.byref(first))
        cs.check(rc == 0, f'the quantization check failed to run: {rc}')
        out[card] = {'mismatches': bad.value,
                     'first': None if bad.value == 0 else hex(first.value)}
    return out


def stamps(lib, seed, K) -> dict:
    """Where a stall-mode call at K x 1024 goes, by the stamps: cycles from the
    CTA's start to each point (median of 20 calls), decoding and stalled."""
    rng = np.random.default_rng(seed)
    card = 1024
    pdfs_np, syms_np = case(rng, 8, K, card)
    data = host_bytes(pdfs_np, syms_np)
    pdfs = torch.from_numpy(pdfs_np).cuda()
    bits = stream_tensor(data, 8, K, 'cuda')
    state = k6.init_state('cuda')
    out = torch.zeros(1, K, dtype=torch.int32, device='cuda')
    for t in range(4):
        k6.lm_coder(pdfs[t:t + 1], out, state, bits, decode=True, n_bits_in=8 * len(data))
    result = {}
    buf = np.zeros(128, np.int64)
    for label, n in (('decodes', 8 * len(data)), ('stalls', int(state[k6.BIT_POS]))):
        runs = []
        for _ in range(20):
            st = state.clone()
            torch.cuda.synchronize()
            rc = lib.encodec_lm_coder_f32(
                k6.STREAM, pdfs[4:5].data_ptr(), 1, K, card, k6.cdf_scale(card), out.data_ptr(),
                st.data_ptr(), bits.data_ptr(), 8 * bits.numel(), n, 0, None, 0,
                torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f'stamps launch failed: {rc}')
            torch.cuda.synchronize()
            cs.check(lib.encodec_lm_coder_stamps(buf.ctypes.data) == 0, 'stamps read failed')
            runs.append(buf.copy() - buf[0])
        med = np.median(np.stack(runs), axis=0).astype(np.int64)
        rows = min(K, 18)
        result[label] = dict(
            coder_start=int(med[1]), state_and_window=int(med[2]), end=int(med[3]),
            row_ready=[int(med[4 + 2 * r]) for r in range(rows)],
            row_coded=[int(med[5 + 2 * r]) for r in range(rows)],
            producer_start=[int(med[64 + r]) for r in range(rows)],
            producer_end=[int(med[96 + r]) for r in range(rows)])
    return result


def short_encodes(lib, seed, rounds: int = 3) -> dict:
    """``push_frame``'s encode (one step of K 8 at card 1024, on a fresh state
    and zeroed buffer) and the flush (no step, ``finish``, on the state after
    a step) as K6's one launch (the probe library's ``encodec_lm_coder_f32``)
    against two launches (``encodec_lm_coder_encode_two``, its scratch from
    ``torch.empty`` as the wrapper would make it), both through ctypes with
    the same arguments: the bytes and state equal to the plain version's
    first, then ``rounds`` rounds of ``chip_smoke.timed_turns`` (two, one,
    one, two), each by CUDA events and on the device."""
    K, card = 8, 1024
    pdfs_np, syms_np = case(np.random.default_rng(seed), 1, K, card)
    pdfs, syms = torch.from_numpy(pdfs_np).cuda(), torch.from_numpy(syms_np).cuda()
    scale, stream = k6.cdf_scale(card), torch.cuda.current_stream().cuda_stream
    cap = k6.stream_bytes(k6.bits_capacity(K))
    after = k6.init_state()
    k6.lm_coder_reference(pdfs.cpu(), syms.cpu(), after, torch.zeros(cap, dtype=torch.uint8),
                          decode=False)

    def one(steps, finish):
        def call(state, bits):
            rc = lib.encodec_lm_coder_f32(
                k6.ENCODE, pdfs.data_ptr(), steps, K, card, scale, syms.data_ptr(),
                state.data_ptr(), bits.data_ptr(), 8 * bits.numel(), 0, finish, None, 0, stream)
            cs.check(rc == 0, f'one launch failed: {rc}')
        return call

    def two(steps, finish):
        def call(state, bits):
            scratch = torch.empty(2 * steps * K, dtype=torch.int32, device='cuda')
            rc = lib.encodec_lm_coder_encode_two(
                pdfs.data_ptr(), steps * K, card, scale, syms.data_ptr(), state.data_ptr(),
                bits.data_ptr(), 8 * bits.numel(), finish, scratch.data_ptr(), stream)
            cs.check(rc == 0, f'two launches failed: {rc}')
        return call

    out = {}
    for label, steps, finish, start in (('push_frame encode', 1, 0, k6.init_state()),
                                        ('flush', 0, 1, after)):
        want_state, want_bits = start.clone(), torch.zeros(cap, dtype=torch.uint8)
        k6.lm_coder_reference(pdfs[:steps].cpu(), syms[:steps].cpu(), want_state, want_bits,
                              decode=False, finish=bool(finish))
        for name, make in (('one', one), ('two', two)):
            st, b = start.cuda(), torch.zeros(cap, dtype=torch.uint8, device='cuda')
            make(steps, finish)(st, b)
            cs.check(torch.equal(st.cpu(), want_state) and torch.equal(b.cpu(), want_bits),
                     f'{label}: {name} launch(es) differ from the plain version')
        ring = cs.FreshRing(200, start.cuda(), torch.zeros(cap, dtype=torch.uint8, device='cuda'))
        calls = {'before': lambda c=two(steps, finish): c(*ring.take()),
                 'new': lambda c=one(steps, finish): c(*ring.take())}
        turns = [cs.timed_turns(torch, calls, runs=50, warmup=5, refresh=ring.refresh)
                 for _ in range(rounds)]
        out[label] = {f'{name}_{unit}': [t[f'{prefix}{unit}'] for t in turns]
                      for name, prefix in (('one', ''), ('two', 'before_'))
                      for unit in ('ms', 'device_ms')}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', type=Path, default=ROOT / 'build' / 'probe',
                        help='where the numbers (probe_lm_coder.json) and the SASS go')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('probe_torch_lm_coder: needs a CUDA card', file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    cs.log(f'device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    _build.load()
    result = {'device': smi}
    result['host_us'] = host_breakdown()
    cs.log(f'host us a part of a decode call (K 8, card 1024, no sync): {result["host_us"]}')
    lib = stamps_library(args.out)
    result['quantize_check'] = q = check_quantize(lib)
    cs.log(f'branch-free quantization against IEEE division, every float32 bit pattern: {q}')
    ok = all(v['mismatches'] == 0 for v in q.values())
    result['latency_cycles'] = lat = latencies(lib)
    cs.log(f'dependent-chain cycles a link, one warp: {lat}')
    result['stamps'] = {}
    for K in (8, 32):
        result['stamps'][K] = st = stamps(lib, args.seed + K, K)
        for label, v in st.items():
            cs.log(f'stamps K {K}, a stall-mode call that {label} (cycles from the CTA\'s '
                   f'start): {v}')
    result['short_encodes'] = enc = short_encodes(lib, args.seed)
    for label, v in enc.items():
        cs.log(f'{label} (K 8, card 1024), ms in rounds of turns: one launch by events '
               f'{v["one_ms"]}, on the device {v["one_device_ms"]}; two launches by events '
               f'{v["two_ms"]}, on the device {v["two_device_ms"]}')
    out = args.out / 'probe_lm_coder.json'
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(cs.json_safe(result), indent=1))
    cs.log(f'wrote {out}; the quantization check passed: {ok}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
