#!/usr/bin/env python3
"""Drive the PyTorch port's 24 kHz codec path, its streaming and serving path,
its GAN training step and the 48 kHz stereo family (codec, CodecServer,
training step) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--before DIR]

Run it from the root of a checkout: it imports ``encodec_pytorch_tpu_torch``
from beside this file, and needs a CUDA card and ``nvcc``. It never falls back
to the CPU. Phases, in the order they run, each of which fails the run:

1. Build the CUDA kernels from ``encodec_pytorch_tpu_torch/csrc`` with nvcc.
2. K1 and K2 against their plain PyTorch versions on the card, at the main
   path's shapes, with median times by CUDA events (20 runs; 5 for the plain
   LSTM loop, ~0.1 s a call): K1 (RVQ cascade) at M in {750, 12000} rows and
   n_q in {8, 32}, and at the serving path's M 64 (a mux tick) and M 8 (a
   join) at n_q 8, with the squared norms cached as the main path has them;
   codes must be >= 99 % identical, and every row whose codes differ must
   first differ at a near-tie (rule in ``rvq_first_differences``). Each shape
   logs its launch (the cluster size, rows a tile and CTAs) and, beside the
   CUDA-event time of a wrapper call, the kernel's own device time from
   ``torch.profiler`` (at the serving shapes the former is mostly host).
   K2 (LSTM recurrence) at H = C = 512 from a zero state at (T, B) in
   (750, 1), (750, 16), (750, 32), (150, 32), and with a carried state
   (random h0 and c0) at (T 4, B 16), the mux tick's shape, and (T 750, B 1);
   max |h - h_plain| and |c_T - c_plain| <= 1e-4. Timed at each shape: the
   kernel alone, the port's whole layer (projection by ``torch.matmul``, bias,
   kernel) and one cuDNN ``nn.LSTM`` layer with the same weights and state
   (which projects too); then the share of a step spent staging, in the gate
   dot, in the cell update and at the grid barrier (``clock64`` stamps) at
   T 750, B 1 and 16.
3. The port's CLI, in process, at full ``encodec_24khz`` width with seeded
   random weights written as a released-layout ``.th``: a 10 s, 24 kHz wav to
   ``.ecdc`` at 6 kbps and back to wav. The K1, K2 and K3 launch counters are
   set to 0 just before and must be > 0 just after.
4. Checks of that output: header (nc 8, al 240000), length, finite values, the
   file's codes equal the in-process encode, the CLI's wav equals the decode.
   Then the same clip through the plain versions: >= 99 % identical codes and
   a decode SNR >= 20 dB against the kernel path. Real-time factors: the
   compress+decompress round trip at B = 1 and encode->decode at B = 16. A
   24 kbps run exercises n_q = 32.
5. K3 (the fused SEANet resblock) against its plain version (pad, ELU and
   cuDNN's ``F.conv1d`` with TF32 off) at the 8 offline shapes of a 10 s
   encode + decode (B 1: C 32/64/128/256 at T 240000/120000/30000/6000, each
   block with its own seeded weights) and the 4 tick shapes of the mux (B 16:
   T 1280/640/160/32, with a streaming halo), plus non-causal padding at C 32
   and a ragged T: max |d| / max|ref| <= 1e-5, kernel (and its device time)
   and plain ms, bound, the launch (cluster size, columns a tile, units); at
   each tick shape, three streamed chunks with a carried halo bit-equal to
   the offline call.
6. The serving path at full width with the seeded weights of phase 3: a
   ``StreamingServer`` of 16 slots, 4 hops a chunk, 6 kbps, warmed up by one
   short stream; then 16 streams of 224 hops (2.99 s), joining at staggered
   ticks with first chunks of 8 hops. Each stream's codes >= 99 % equal to
   the offline ``encode`` of its clip and its audio >= 20 dB SNR against the
   offline decode. The K1, K2 and K3 counters are set to 0 before and must be
   > 0 after, also counted inside the batched step alone. Aggregate audio
   seconds per second, tick ms, steady chunk latency p50/p99. Then a
   ``CodecServer`` with length buckets takes 8 concurrent round trips of mixed
   lengths: each >= 20 dB SNR against a direct call except in its final hop
   (the reflect model is tail-exact), with coalescing.
7. K4 (discriminator conv, 3xTF32 on the tensor cores) against its plain
   version (cuDNN's ``F.conv2d`` and ``conv2d_input``, TF32 off) at the 12
   eligible conv shapes of one discriminator call at the training config
   (B 12, 72000 samples): forward and input gradient within 1e-5 · max|ref|;
   median times by CUDA events, and two bounds a shape: 3 x the operations at
   the TF32 tensor-core peak, and the operations at the f32 CUDA-core peak
   (each no less than the bytes' time).
8. The training path through the port's ``train_cli``, in process, at the full
   width of ``encodec_pytorch_tpu/configs/config.yaml`` in f32: 36 synthetic
   3 s wavs (one epoch = 3 steps of 12 x 72000), no LR warmup so the
   discriminator trains. K4's forward and dx counters and K2's are set to 0
   just before and must be > 0 just after; losses finite; the generator, the
   discriminator and the codebooks changed. ms per step and peak memory.
9. One more step from the trained state twice (at the largest n_q whose
   codebooks are initialized), once through the kernels and once with every
   kernel swapped for its plain version: losses within
   1e-3 relative, gradients within 1e-3 and updates within 1e-2 by relative
   norm (a code flipped at an f32 near-tie moves them more than roundoff).
10. K4 at the 48 kHz training config's shapes (B 32, 48000 stereo samples):
    conv_4's forward (K5 takes conv_1..conv_3's) and the input gradient of
    conv_1..conv_4, as phase 7 checks and times them.
11. K5 (the discriminator's im2col conv, 3xTF32 on the tensor cores) against
    its plain version (the im2col GEMM in torch) and cuDNN's ``F.conv2d``
    (TF32 off) at the 9 F-stride-2 conv shapes of one discriminator call at
    the 48 kHz training config (B 32, 48000 stereo samples): within 1e-5 ·
    max|ref| of both, bit-equal on a repeat, its weight packing bit-equal to
    the plain packing, and the trainable route's dx and dW (K4's dx, cuDNN's
    dW) within 1e-5 of ``F.conv2d``'s autograd. At each shape: median times
    by CUDA events of the wrapper, the kernel alone, the packing, the plain
    version, cuDNN and K4's forward (the in-house yardstick), the kernel's
    device time from ``torch.profiler``, and two bounds (3xTF32, f32).
12. The 48 kHz codec CLI (``-q``), in process, at full ``encodec_48khz`` width
    with seeded weights: a 10 s stereo wav to ``.ecdc`` and back at 6 kbps;
    header (``m encodec_48khz``, ``al 480000``, ``nc 4``), 11 frames each with
    its scale, the last one short; the file's codes and scales equal the
    in-process encode; >= 99 % identical codes and a decode SNR >= 20 dB
    against the plain versions; ``encode_segmajor`` against ``encode``
    >= 99 %; the K1 and K2 counters > 0 and K3's 0 (its resblocks use
    ``time_group_norm``); RTF of the round trip at B 1; a 24 kbps run (n_q 16).
13. A ``CodecServer`` on the 48 kHz model: 8 concurrent stereo round trips of
    1.5, 3, 6 and 10 s (two each), each >= 20 dB SNR against a direct call,
    coalesced into fewer than 8 batches.
14. The 48 kHz training path through ``train_cli --config config_48k_stereo``
    at full width (B 32 x 48000 stereo, f32; 96 synthetic 1.25 s clips, one
    epoch of 3 steps, no LR warmup): the K5, K4 (forward and dx) and K2
    counters > 0; finite losses; the generator, the discriminator and the
    codebooks changed; ms per step and peak memory; then phase 9's
    kernel-vs-plain step at this config.

With ``--before DIR`` (another checkout of the port, e.g. the parent commit
unpacked with ``git archive``), phases 2, 5 and 11 also run that checkout's
K1, K3 and K5 on the same inputs: its time beside the kernel's, and whether
the codes and outputs are bit-equal to it (for K5, how far they differ).

Output: one line per measurement (each phase's start with the seconds since
the script started), then a JSON line with each kernel's numbers (launches:
the 24 and 48 kHz codec CLIs' and servers' for K1, K2 and K3; both training
paths' for K4; the 48 kHz training steps' for K5; K1's and K2's entries list
every timed shape under ``shapes``, K3's its 8 offline and 4 tick shapes,
K4's the totals of both configs, K5's its 9 shapes), the ``nvidia-smi`` name
and power-limit line, and last ``{"ok": true, "device": {...}}``. Without a card,
or outside a checkout, it exits non-zero and prints no result.
"""

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SR = 24_000
SR48 = 48_000
SECONDS = 10
K1_TOL_SHARE = 0.99
K1_NEAR_TIE_REL = 1e-5
K2_TOL = 1e-4
K3_TOL_REL = 1e-5
K4_TOL_REL = 1e-5
K5_TOL_REL = 1e-5
SNR_MIN_DB = 20.0
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL = 1e-3
TRAIN_UPDATE_REL = 1e-2
# NVIDIA's data sheet, H100 SXM: f32 on CUDA cores, TF32 on the tensor cores
# (dense), and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


class Failed(Exception):
    pass


START = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def phase(name: str):
    log(f'--- {name} (at {time.perf_counter() - START:.1f} s)')


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def nvidia_smi_line() -> str:
    proc = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(), f'nvidia-smi failed: {proc.stderr}')
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, runs=20, warmup=3) -> float:
    """Median milliseconds of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
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


def device_ms(torch, fn, kernel: str, runs=20, tries=3):
    """Mean device milliseconds a call of ``fn`` spends in kernels whose name
    holds ``kernel``, by ``torch.profiler`` (CUPTI); None if no try saw any.
    Unlike ``cuda_ms`` it leaves out the host's launch cost."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / runs
    return None


def fmt_ms(v) -> str:
    return 'not measured' if v is None else f'{v:.4f} ms'


def bound_ms(flops: float, nbytes: float):
    """(least ms the card could take, 'operations' or 'bytes')."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def _tones(rng, t: np.ndarray) -> np.ndarray:
    out = np.zeros(t.size)
    for _ in range(4):
        f = rng.uniform(80, 4000)
        vib = 1 + 0.01 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
        out += rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * f * t * vib + rng.uniform(0, 2 * np.pi))
    return out


def make_clip(seed: int, batch: int, seconds: float = SECONDS, sr: int = SR,
              channels: int = 1) -> np.ndarray:
    """``[batch, channels, T]`` f32 audio: a few tones with vibrato plus noise
    (stereo: the right channel mixes the left with tones of its own)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    out = np.zeros((batch, channels, t.size))
    for b in range(batch):
        out[b, 0] = _tones(rng, t) + 0.03 * rng.standard_normal(t.size)
        if channels == 2:
            out[b, 1] = 0.6 * out[b, 0] + 0.4 * _tones(rng, t)
        out[b] *= 0.5 / np.abs(out[b]).max()
    return out.astype(np.float32)


def rvq_first_differences(torch, x, embed, codes, plain):
    """(rows whose codes differ, those whose first difference is not a near-tie).

    Near-tie rule: at the first stage k where a row's codes differ, score the
    row's plain-path residual against E_k with the plain formula; the
    difference is a near-tie if the plain pick's score exceeds the kernel
    pick's score by at most K1_NEAR_TIE_REL times the plain pick's |score|.
    When the kernel took the runner-up, that is the plain top-2 gap.
    """
    diff = codes != plain
    rows = diff.any(0)
    if not bool(rows.any()):
        return 0, 0
    first = diff.int().argmax(0)
    residual = x.clone()
    esq = torch.sum(torch.square(embed), -1)
    not_tie = 0
    for k in range(embed.shape[0]):
        sel = rows & (first == k)
        if bool(sel.any()):
            s = 2.0 * torch.matmul(residual[sel], embed[k].t()) - esq[k][None, :]
            a = s.gather(1, plain[k, sel].long()[:, None])
            b = s.gather(1, codes[k, sel].long()[:, None])
            not_tie += int(((a - b).abs() > K1_NEAR_TIE_REL * a.abs()).sum())
        residual = residual - embed[k][plain[k].long()]
    return int(rows.sum()), not_tie


def k1_phase(torch, rvq_kernel, gen, before=None):
    """K1 against its plain version at the codec's and the serving path's
    shapes, called as the main path calls it (squared norms cached); with
    ``before`` (the kernel modules of an earlier checkout, ``--before``) also
    that kernel's codes and time on the same inputs. Returns the summary at
    (M 750, n_q 8), with every shape under ``shapes``."""
    from encodec_pytorch_tpu_torch.quantization.core_vq import rvq_decode
    D, N = 128, 1024
    summary, shapes = None, []
    # the codec path's shapes (10 s: 750 frames; 16 x 10 s: 12000), and the
    # serving path's: a mux tick (16 slots x 4 frames) and a B = 1 join (8 frames)
    for M, K in ((750, 8), (750, 32), (12000, 8), (12000, 32), (64, 8), (8, 8)):
        x = torch.randn(M, D, generator=gen, device='cuda')
        scale = 0.7 ** torch.arange(K, device='cuda', dtype=torch.float32)
        embed = (torch.randn(K, N, D, generator=gen, device='cuda')
                 * scale[:, None, None]).contiguous()
        esq = rvq_kernel.codebook_sq_norms(embed)
        codes = rvq_kernel.rvq_encode(x, embed, esq)
        plain = rvq_kernel.rvq_encode_reference(x, embed)
        torch.cuda.synchronize()
        same = float((codes == plain).float().mean())
        n_diff, not_tie = rvq_first_differences(torch, x, embed, codes, plain)
        err = float((rvq_decode(embed, codes[:, None]) - rvq_decode(embed, plain[:, None]))
                    .abs().max())
        ms = cuda_ms(torch, lambda: rvq_kernel.rvq_encode(x, embed, esq))
        plain_ms = cuda_ms(torch, lambda: rvq_kernel.rvq_encode_reference(x, embed))
        b_ms, b_by = bound_ms(2.0 * M * N * D * K, 4.0 * (M * D + K * N * D + K * M))
        dev_ms = device_ms(torch, lambda: rvq_kernel.rvq_encode(x, embed, esq), 'rvq_cascade')
        cfg = rvq_kernel.launch_config(M, N)
        ctas = -(-M // cfg['rows_per_tile']) * cfg['cluster']
        log(f'K1 rvq_encode M={M} n_q={K} N={N} D={D}: identical codes {same:.6f}, '
            f'rows differing {n_diff}, not near-tie {not_tie}, '
            f'max |dequantized diff| {err:.3e}, kernel {ms:.4f} ms (on the device '
            f'{fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, '
            f'bound {b_ms:.4f} ms ({b_by}); launch: clusters of {cfg["cluster"]} CTAs, '
            f'{cfg["rows_per_tile"]} rows a tile, {cfg["bins_per_buffer"]} bins a buffer, '
            f'{ctas} CTAs')
        check(same >= K1_TOL_SHARE and not_tie == 0,
              f'K1 disagrees with its plain version at M={M} n_q={K}')
        entry = dict(M=M, n_q=K, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, identical=same, max_abs_err=err, cluster=cfg['cluster'],
                     rows_per_tile=cfg['rows_per_tile'])
        if before is not None:
            old = before.rvq_kernel.rvq_encode(x, embed)
            torch.cuda.synchronize()
            old_call = lambda: before.rvq_kernel.rvq_encode(x, embed)
            entry.update(before_ms=cuda_ms(torch, old_call),
                         before_device_ms=device_ms(torch, old_call, 'rvq_cascade'),
                         equal_to_before=bool(torch.equal(codes, old)))
            log(f'K1 M={M} n_q={K}: the earlier kernel (--before) {entry["before_ms"]:.4f} ms '
                f'(on the device {fmt_ms(entry["before_device_ms"])}), codes bit-equal to it: '
                f'{entry["equal_to_before"]}')
        shapes.append(entry)
        if (M, K) == (750, 8):
            summary = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
        else:
            summary['max_abs_err'] = max(summary['max_abs_err'], err)
    summary['shapes'] = shapes
    return summary


def k2_phase(torch, lstm_kernel, gen):
    """K2 against its plain version, and timed like for like against cuDNN:
    at each shape the kernel alone, the port's whole layer (the ``torch.matmul``
    input projection, the bias and K2: what ``ops/lstm.py`` runs) and one
    cuDNN ``nn.LSTM`` layer with the same weights (which also projects).
    Then where a step goes (``lstm_step_profile``) at T 750, B 1 and 16.
    Returns the summary at (T 750, B 1), with every shape under ``shapes``."""
    H = C = 512
    bound = 1 / H ** 0.5
    summary, shapes = None, []
    # offline shapes (zero state): the B 1 codec, the B 16 bulk path, and B 32
    # (the 48 kHz step; segments x requests at T 150); carried states: the
    # mux tick (T 4, B 16) and a long carried run (T 750, B 1)
    for T, B, carried in ((750, 1, False), (750, 16, False), (750, 32, False),
                          (150, 32, False), (4, 16, True), (750, 1, True)):
        x = torch.randn(T, B, C, generator=gen, device='cuda')
        w_ih = (torch.rand(4 * H, C, generator=gen, device='cuda') * 2 - 1) * bound
        w_hh = ((torch.rand(4 * H, H, generator=gen, device='cuda') * 2 - 1) * bound).contiguous()
        bias = (torch.rand(4 * H, generator=gen, device='cuda') * 2 - 1) * bound
        state = ((torch.randn(B, H, generator=gen, device='cuda') * 0.5,
                  torch.randn(B, H, generator=gen, device='cuda')) if carried else (None, None))
        xp = (torch.matmul(x, w_ih.t()) + bias).contiguous()
        h, c = lstm_kernel.lstm_recurrence(xp, w_hh, *state)
        hp, cp = lstm_kernel.lstm_recurrence_reference(xp, w_hh, *state)
        torch.cuda.synchronize()
        err = max(float((h - hp).abs().max()), float((c - cp).abs().max()))

        def layer():    # what ops/lstm.py runs for one layer on the card
            return lstm_kernel.lstm_recurrence(
                (torch.matmul(x, w_ih.t()) + bias).contiguous(), w_hh, *state)

        cudnn = torch.nn.LSTM(C, H).cuda()
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(w_ih)
            cudnn.weight_hh_l0.copy_(w_hh)
            cudnn.bias_ih_l0.copy_(bias)
            cudnn.bias_hh_l0.zero_()
            hx = None if not carried else (state[0][None].contiguous(), state[1][None].contiguous())
            lib_err = float((cudnn(x, hx)[0] - hp).abs().max())
            library_ms = cuda_ms(torch, lambda: cudnn(x, hx))
        ms = cuda_ms(torch, lambda: lstm_kernel.lstm_recurrence(xp, w_hh, *state))
        layer_ms = cuda_ms(torch, layer)
        plain_ms = cuda_ms(torch, lambda: lstm_kernel.lstm_recurrence_reference(xp, w_hh, *state),
                           runs=5, warmup=1)
        b_ms, b_by = bound_ms(2.0 * T * B * 4 * H * H,
                              4.0 * (T * B * 4 * H + 4 * H * H + T * B * H
                                     + (3 if carried else 1) * B * H))
        kind = 'carried state' if carried else 'zero state'
        log(f'K2 lstm_recurrence {kind} T={T} B={B} H={H}: max |h, c_T - plain| {err:.3e} '
            f'(cuDNN vs plain {lib_err:.3e}); kernel {ms:.4f} ms ({1e3 * ms / T:.3f} us a step), '
            f'layer (projection + bias + kernel) {layer_ms:.4f} ms, cuDNN nn.LSTM layer '
            f'{library_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})')
        check(np.isfinite(err) and err <= K2_TOL,
              f'K2 disagrees with its plain version at T={T} B={B} ({kind}): {err}')
        shapes.append(dict(T=T, B=B, carried=carried, ms=ms, layer_ms=layer_ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                           max_abs_err=err))
        if (T, B, carried) == (750, 1, False):
            summary = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=library_ms)
        summary['max_abs_err'] = max(summary['max_abs_err'], err)
        if T == 750 and B in (1, 16) and not carried:
            p = lstm_kernel.lstm_step_profile(xp, w_hh)
            step_us = 1e3 * ms / T
            log(f'K2 step breakdown T={T} B={B} (clock64 stamps of block 0, shares of '
                f'{p["cycles"]} cycles; us at {step_us:.3f} us a step): '
                + ', '.join(f'{k} {p[k]:.3f} ({p[k] * step_us:.3f} us)'
                            for k in lstm_kernel.STEP_PARTS))
            shapes[-1]['step_shares'] = {k: p[k] for k in lstm_kernel.STEP_PARTS}
    summary['shapes'] = shapes
    return summary


def k3_phase(torch, seed, ckpt: Path, before=None):
    """K3 against its plain version (the cuDNN sequence) at the offline and
    tick shapes, streamed chunks against the offline call at the tick's four
    widths, and with ``before`` (``--before``) the earlier kernel's output and
    time on the same inputs. Returns the summary over the 8 offline blocks,
    with the offline and tick shapes under ``shapes``."""
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.models.seanet import SEANetResnetBlock
    from encodec_pytorch_tpu_torch.ops import resblock_kernel as rk

    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    calls = []

    def record(module, args):   # the block's input; after a transposed conv, a slice
        calls.append((args[0].detach().contiguous(), module))

    blocks = [m for m in model.modules() if isinstance(m, SEANetResnetBlock)]
    hooks = [b.register_forward_pre_hook(record) for b in blocks]
    with torch.no_grad():
        model(torch.from_numpy(make_clip(seed + 11, batch=1)).cuda())
    for h in hooks:
        h.remove()
    check(len(calls) == 8, f'expected 8 resblock calls, found {len(calls)}')
    gen = torch.Generator(device='cuda').manual_seed(seed + 12)
    cases = [('offline', x, m.fused_weights(), True, None) for x, m in calls]
    for x, m in calls[:4]:   # the encoder's blocks at the tick: 16 slots x 4 hops
        T = 1280 * x.shape[-1] // calls[0][0].shape[-1]
        xt = torch.randn(16, x.shape[1], T, generator=gen, device='cuda') * x.std()
        left = torch.randn(16, x.shape[1], 2, generator=gen, device='cuda') * x.std()
        cases.append(('tick', xt, m.fused_weights(), True, left))
    w32 = calls[0][1].fused_weights()
    x32 = calls[0][0]
    cases += [('non-causal', x32, w32, False, None),
              ('ragged', x32[..., :1001].contiguous(), w32, True, None)]
    tot = {k: 0.0 for k in ('ms', 'device_ms', 'plain_ms', 'bound_ms')}
    if before is not None:
        tot.update(before_ms=0.0, before_device_ms=0.0)
    worst = 0.0
    shapes = []
    for name, x, w, causal, left in cases:
        kw = dict(dilation=1, causal=causal, pad_mode='reflect', left=left)
        got = rk.resblock(x, *w, **kw)
        ref = rk.resblock_reference(x, *w, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = cuda_ms(torch, lambda: rk.resblock(x, *w, **kw))
        plain_ms = cuda_ms(torch, lambda: rk.resblock_reference(x, *w, **kw))
        B, C, T = x.shape
        flops = 6.0 * C * C * B * T
        b_ms, b_by = bound_ms(flops, 4.0 * (2 * B * C * T + sum(t.numel() for t in w)))
        dev_ms = device_ms(torch, lambda: rk.resblock(x, *w, **kw), 'resblock_kernel')
        cfg = rk.launch_config(C, w[0].shape[0])
        units = -(-T // cfg['tile']) * B
        log(f'K3 resblock {name} x {tuple(x.shape)}: max |d| {err:.3e} ({rel:.2e} of max), '
            f'kernel {ms:.4f} ms (on the device {fmt_ms(dev_ms)}), plain (pad, ELU, cuDNN '
            f'conv1d x3, add) {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, '
            f'{flops / 1e9:.3f} GFLOP); launch: clusters of {cfg["cluster"]} CTAs, '
            f'{cfg["tile"]} columns a tile, {units} tiles x rows')
        check(rel <= K3_TOL_REL, f'K3 disagrees with its plain version: {name} {tuple(x.shape)}')
        worst = max(worst, err)
        entry = dict(case=name, shape=list(x.shape), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                     bound_ms=b_ms, max_abs_err=err, cluster=cfg['cluster'], tile=cfg['tile'])
        if before is not None:
            old = before.resblock_kernel.resblock(x, *w, **kw)
            torch.cuda.synchronize()
            old_call = lambda: before.resblock_kernel.resblock(x, *w, **kw)
            entry.update(before_ms=cuda_ms(torch, old_call),
                         before_device_ms=device_ms(torch, old_call, 'resblock_kernel'),
                         equal_to_before=bool(torch.equal(got, old)))
            log(f'K3 {name} x {tuple(x.shape)}: the earlier kernel (--before) '
                f'{entry["before_ms"]:.4f} ms (on the device '
                f'{fmt_ms(entry["before_device_ms"])}), output bit-equal to it: '
                f'{entry["equal_to_before"]}')
        if name in ('offline', 'tick'):
            shapes.append(entry)
        if name == 'offline':   # a total is not measured if one of its terms is not
            for k in tot:
                tot[k] = None if tot[k] is None or entry.get(k) is None else tot[k] + entry[k]
        if name == 'tick':   # streamed chunks with a carried halo give the offline bits
            offline = rk.resblock(x, *w, dilation=1, causal=True)
            outs, halo, pos = [], None, 0
            for n in (T // 2 + 3, T // 4, T - T // 2 - 3 - T // 4):
                out, halo = rk.resblock(x[..., pos:pos + n].contiguous(), *w, dilation=1,
                                        causal=True, left=halo, return_carry=True)
                outs.append(out)
                pos += n
            same = bool(torch.equal(torch.cat(outs, -1), offline))
            log(f'K3 streamed chunks at C {C}, T {T}: bit-equal to the offline call: {same}')
            check(same, f'K3 streamed chunks differ from the offline call at C {C}')
    log(f'K3 over the 8 blocks of a 10 s encode + decode: kernel {tot["ms"]:.3f} ms (on the '
        f'device {fmt_ms(tot["device_ms"])}), plain {tot["plain_ms"]:.3f} ms, bound '
        f'{tot["bound_ms"]:.3f} ms'
        + (f', the earlier kernel {tot["before_ms"]:.3f} ms (on the device '
           f'{fmt_ms(tot["before_device_ms"])})' if before is not None else ''))
    return dict(max_abs_err=worst, ms=tot['ms'], device_ms=tot['device_ms'],
                plain_ms=tot['plain_ms'], bound_ms=tot['bound_ms'], bound_by='operations',
                library_ms=tot['plain_ms'], shapes=shapes)


def load_before(path: Path):
    """The kernel modules of another checkout of the port (``--before``),
    imported as the package ``before_port`` beside this one; its kernels build
    into that checkout's own ``build/``."""
    import importlib
    import importlib.util
    pkg = Path(path).resolve() / 'encodec_pytorch_tpu_torch'
    spec = importlib.util.spec_from_file_location('before_port', pkg / '__init__.py',
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules['before_port'] = module
    spec.loader.exec_module(module)
    ops = importlib.import_module('before_port.ops')
    for name in ('_build', 'rvq_kernel', 'resblock_kernel', 'disc_im2col_kernel'):
        importlib.import_module(f'before_port.ops.{name}')
    return ops


@contextlib.contextmanager
def plain_path():
    """Route the port through the kernels' plain versions (for comparison)."""
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import lstm_kernel, resblock_kernel, rvq_kernel
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
    swaps = [(lstm_kernel, 'lstm_recurrence', lstm_kernel.lstm_recurrence_reference),
             (resblock_kernel, 'resblock', resblock_kernel.resblock_reference),
             (rvq_kernel, 'rvq_encode',
              lambda x, embed, esq=None: rvq_kernel.rvq_encode_reference(x, embed)),
             (dck, 'disc_conv_forward', dck.disc_conv_forward_reference),
             (dck, 'disc_conv_input_grad', dck.disc_conv_input_grad_reference),
             (k5, 'disc_im2col_forward', k5.disc_im2col_forward_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


CKPT = 'encodec_24khz_seeded.th'
CKPT48 = 'encodec_48khz_seeded.th'
CODEC_KERNELS = ('rvq_encode', 'lstm_recurrence', 'resblock')


def _codec_entries():
    from encodec_pytorch_tpu_torch.ops import lstm_kernel, resblock_kernel, rvq_kernel
    return {'rvq_encode': rvq_kernel.rvq_encode, 'lstm_recurrence': lstm_kernel.lstm_recurrence,
            'resblock': resblock_kernel.resblock}


def reset_counts():
    """Set the codec path's kernel launch counters to 0."""
    for fn in _codec_entries().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _codec_entries().items()}


def write_seeded_checkpoint(torch, seed: int, path: Path, name: str = 'encodec_24khz'):
    """Full-width ``name`` (a port model) with seeded weights; each stage's
    codebook is 1024 latents drawn from a separate seeded clip (for the
    segmented 48 kHz model, eight normalized 1 s segments), taken at that
    stage's residual (plus 5 % noise), so codes spread over the codebook."""
    from encodec_pytorch_tpu_torch.models.model import MODELS
    from encodec_pytorch_tpu_torch.ops.rvq_kernel import rvq_encode_reference
    model = MODELS[name](device='cuda', generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device='cuda').manual_seed(seed + 1)
    with torch.no_grad():
        if model.segment is None:
            clip = make_clip(seed + 1, batch=2)
        else:
            clip = make_clip(seed + 1, batch=8, seconds=model.segment, sr=model.sample_rate,
                             channels=model.channels)
        frame, _ = model._normalize_frame(torch.from_numpy(clip).cuda())
        z = model.encoder(frame)
        residual = z.transpose(1, 2).reshape(-1, z.shape[1])
        for layer in model.quantizer.vq.layers:
            pick = torch.randint(residual.shape[0], (1024,), generator=gen, device='cuda')
            noise = torch.randn(1024, residual.shape[1], generator=gen, device='cuda')
            embed = residual[pick] + 0.05 * residual.std() * noise
            cb = layer._codebook
            cb.embed.copy_(embed)
            cb.embed_avg.copy_(embed)
            cb.inited.fill_(1.)
            idx = rvq_encode_reference(residual, embed[None])[0]
            residual = residual - embed[idx.long()]
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def snr_db(ref, test) -> float:
    noise = float(((test - ref) ** 2).sum())
    return float('inf') if noise == 0 else 10 * np.log10(float((ref ** 2).sum()) / noise)


def main_path_phase(torch, seed, tmp: Path):
    from encodec_pytorch_tpu_torch import cli
    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.bitstream.binary import read_ecdc_header
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.ops import lstm_kernel, resblock_kernel, rvq_kernel
    from encodec_pytorch_tpu_torch.utils import read_wav, write_wav

    ckpt = tmp / CKPT
    write_seeded_checkpoint(torch, seed, ckpt)
    wav_in, ecdc, wav_out = tmp / 'in.wav', tmp / 'out.ecdc', tmp / 'out.wav'
    write_wav(wav_in, make_clip(seed, batch=1)[0], SR)
    common = ['-m', 'encodec_24khz', '-c', str(ckpt), '--device', 'cuda', '-f']

    reset_counts()
    t0 = time.perf_counter()
    cli.main([str(wav_in), str(ecdc), '-b', '6', *common])
    cli.main([str(ecdc), str(wav_out), *common])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    log(f'main path: CLI compress + decompress of {SECONDS} s in {cli_s:.2f} s '
        f'(model loads included); kernel launches {launches}')
    check(all(v > 0 for v in launches.values()),
          f'the main path did not go through every kernel: {launches}')

    data = ecdc.read_bytes()
    fo = io.BytesIO(data)
    meta = read_ecdc_header(fo)
    log(f'main path: .ecdc {len(data)} bytes, header {meta}')
    check(meta['m'] == 'encodec_24khz' and meta['nc'] == 8 and meta['al'] == SR * SECONDS
          and meta['lm'] is False, f'bad header {meta}')
    out, sr = read_wav(wav_out)
    check(sr == SR and out.shape == (1, SR * SECONDS) and np.isfinite(out).all(),
          f'bad output wav {out.shape} at {sr} Hz')

    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    wav, _ = read_wav(wav_in)
    x = torch.from_numpy(wav[None]).cuda()
    codes = model.encode(x)[0][0]
    file_codes = C._decompress_frame_packed(model, fo, meta['nc'], meta['fr'])
    check(np.array_equal(file_codes, codes[0].cpu().numpy()),
          'the .ecdc codes differ from the in-process encode')
    dec = model.decode([(codes, None)])[0].cpu().numpy()
    check(np.isfinite(dec).all(), 'non-finite decode')
    check(np.abs(out - np.clip(dec, -0.99, 0.99)).max() <= 2 / 32768,
          "the CLI's wav differs from the in-process decode")
    with plain_path():
        codes_p = model.encode(x)[0][0]
        dec_p = model.decode([(codes_p, None)])[0].cpu().numpy()
    same = float((codes == codes_p).float().mean())
    snr = snr_db(dec_p, dec)
    log(f'main path 6 kbps: identical codes kernel vs plain {same:.6f}, '
        f'decode SNR kernel vs plain {snr:.2f} dB, distinct codes used {len(torch.unique(codes))}')
    check(same >= K1_TOL_SHARE and snr >= SNR_MIN_DB, 'kernel path disagrees with plain path')

    def round_trip():
        return C.decompress(model, C.compress(model, wav))

    round_trip()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_trip()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t1 = statistics.median(times)
    log(f'RTF round trip (compress + decompress, B=1, {SECONDS} s): {SECONDS / t1:.2f} '
        f'(median {t1 * 1000:.1f} ms of 5)')

    x16 = torch.from_numpy(make_clip(seed + 3, batch=16)).cuda()
    model.decode(model.encode(x16))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y16 = model.decode(model.encode(x16))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t16 = statistics.median(times)
    check(y16.shape == x16.shape and bool(torch.isfinite(y16).all()), 'bad B=16 output')
    log(f'RTF encode->decode (EncodecModel, B=16, {SECONDS} s each): {16 * SECONDS / t16:.2f} '
        f'(median {t16 * 1000:.1f} ms of 3)')

    model.set_target_bandwidth(24.)
    data24 = C.compress(model, wav)
    meta24 = read_ecdc_header(io.BytesIO(data24))
    out24, _ = C.decompress(model, data24)
    codes24 = model.encode(x)[0][0]
    with plain_path():
        codes24_p = model.encode(x)[0][0]
    same24 = float((codes24 == codes24_p).float().mean())
    log(f'24 kbps: header nc {meta24["nc"]}, {len(data24)} bytes, identical codes kernel vs '
        f'plain {same24:.6f}')
    check(meta24['nc'] == 32 and out24.shape == (1, SR * SECONDS) and np.isfinite(out24).all()
          and same24 >= K1_TOL_SHARE, '24 kbps run failed')
    return launches


STREAMS = 16
CHUNK_HOPS = 4
FIRST_HOPS = 8
STREAM_HOPS = FIRST_HOPS + 54 * CHUNK_HOPS     # 224 hops, 2.99 s


def serving_phase(torch, seed, ckpt: Path):
    """Phase 10: the StreamingServer at full width, then a CodecServer.
    Returns the kernels' launch counts of the streaming run."""
    import threading

    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec, StreamingServer

    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    hop = model.encoder.hop_length
    clips = make_clip(seed + 200, batch=STREAMS, seconds=STREAM_HOPS * hop / SR)
    x = torch.from_numpy(clips).cuda()
    frames = model.encode(x)
    offline_codes = frames[0][0].cpu().numpy()                         # [16, 8, 224]
    offline = model.decode(frames).cpu().numpy()                       # [16, 1, T]

    server = StreamingServer(model, max_streams=STREAMS, chunk_hops=CHUNK_HOPS,
                             max_wait_ms=5.0, bandwidth=6., device='cuda')
    first, chunk = FIRST_HOPS * hop, server.chunk_samples
    check(first >= server.min_first_chunk_samples, 'first chunk below the minimum')
    mux_counts = dict.fromkeys(CODEC_KERNELS, 0)
    real_mux = server._mux

    def counted_mux(*args):
        before = read_counts()
        out = real_mux(*args)
        for k, v in read_counts().items():
            mux_counts[k] += v - before[k]
        return out
    server._mux = counted_mux

    outputs, latencies, errors = [None] * STREAMS, [], []
    lock = threading.Lock()
    with server:   # warm-up, not measured: the first B = 1 join and the first ticks
        with server.open_stream() as stream:
            stream.process(clips[0][:, :first], timeout=120)
            for a in range(first, first + 2 * chunk, chunk):
                stream.process(clips[0][:, a:a + chunk], timeout=120)
    server._stats.update(ticks=0, joins=0, chunks=0)
    server._tick_s.clear()

    def run_stream(i):
        try:
            deadline = time.monotonic() + 120
            while server.stats()['ticks'] < i:     # join at staggered ticks
                check(time.monotonic() < deadline, f'stream {i} never joined')
                time.sleep(0.001)
            with server.open_stream() as stream:
                pieces = [stream.process(clips[i][:, :first], timeout=120, with_codes=True)]
                for a in range(first, clips.shape[-1], chunk):
                    t0 = time.perf_counter()
                    pieces.append(stream.process(clips[i][:, a:a + chunk], timeout=120,
                                                 with_codes=True))
                    with lock:
                        latencies.append(time.perf_counter() - t0)
            outputs[i] = tuple(np.concatenate(p, axis=-1) for p in zip(*pieces))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, repr(e)))

    reset_counts()
    threads = [threading.Thread(target=run_stream, args=(i,)) for i in range(STREAMS)]
    with server:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        stats = server.stats()
    launches = read_counts()
    check(not errors and all(o is not None for o in outputs), f'streams failed: {errors}')
    same = float(np.mean([np.mean(o[1] == offline_codes[i]) for i, o in enumerate(outputs)]))
    snrs = [snr_db(offline[i], o[0]) for i, o in enumerate(outputs)]
    lat = sorted(latencies)
    audio_s = STREAMS * clips.shape[-1] / SR
    log(f'serving: StreamingServer {STREAMS} slots x {CHUNK_HOPS} hops at 6 kbps, {STREAMS} '
        f'streams of {clips.shape[-1] / SR:.3f} s (first chunk {FIRST_HOPS} hops): {audio_s:.2f} '
        f'audio s in {wall:.3f} s = {audio_s / wall:.2f} audio s/s aggregate; ticks '
        f'{stats["ticks"]}, joins {stats["joins"]}, tick ms p50 {stats["tick_ms_p50"]:.3f} p99 '
        f'{stats["tick_ms_p99"]:.3f}; steady chunk latency ms p50 '
        f'{1e3 * lat[len(lat) // 2]:.3f} p99 {1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))]:.3f}')
    log(f'serving: codes equal to offline {same:.6f}; SNR vs offline decode min '
        f'{min(snrs):.2f} dB, median {statistics.median(snrs):.2f} dB; kernel launches '
        f'{launches}, inside the batched step {mux_counts}')
    check(same >= K1_TOL_SHARE and min(snrs) >= SNR_MIN_DB, 'streamed output disagrees with offline')
    check(all(v > 0 for v in launches.values()) and all(v > 0 for v in mux_counts.values()),
          f'the serving path did not go through every kernel: {launches}, mux {mux_counts}')

    codec = LiveCodec(model, device='cuda')
    lengths = [24000, 20000, 31000, 47000, 12000, 39999, 8000, 45000]
    reqs = [make_clip(seed + 300 + i, batch=1, seconds=n / SR)[0] for i, n in enumerate(lengths)]
    direct = [codec.roundtrip(r[None])[0].cpu().numpy() for r in reqs]
    results = [None] * len(reqs)
    with CodecServer(codec, max_batch=8, max_wait_ms=20.0,
                     length_buckets=[24000, 48000]) as cs:
        def call(i):
            results[i] = cs.roundtrip(reqs[i], timeout=120)
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        cstats = cs.stats()
    check(all(r is not None for r in results), 'a CodecServer request did not finish')
    worst_snr, worst_d = float('inf'), 0.0
    for r, d, n in zip(results, direct, lengths):
        check(r.shape == (1, n), f'CodecServer result {r.shape} for {n} samples')
        cut = (-(-n // hop) - 1) * hop
        worst_snr = min(worst_snr, snr_db(d[..., :cut], r[..., :cut]))
        worst_d = max(worst_d, float(np.abs(d[..., :cut] - r[..., :cut]).max()))
    log(f'serving: CodecServer 8 concurrent round trips of mixed lengths, length buckets '
        f'[24000, 48000]: {cstats["batches"]} batches, mean batch {cstats["mean_batch"]:.2f}, '
        f'latency ms p50 {cstats["latency_p50_ms"]:.2f}; vs direct calls but the final hop: '
        f'min SNR {worst_snr:.2f} dB, max |d| {worst_d:.3e}')
    check(worst_snr >= SNR_MIN_DB and cstats['batches'] < len(reqs),
          'CodecServer results disagree with direct calls, or nothing coalesced')
    return launches


TRAIN_SECONDS = 3
# the training paths: (sample rate, channels, seconds a synthetic clip, seed offset)
TRAIN_DATA = {'config': (SR, 1, TRAIN_SECONDS, 100), 'config_48k_stereo': (SR48, 2, 1.25, 500)}


def train_overrides(tmp: Path, seed: int, config: str = 'config') -> list:
    """Three batches of synthetic clips in a CSV (``config``: 36 mono clips of
    3 s at 24 kHz; ``config_48k_stereo``: 96 stereo clips of 1.25 s at 48 kHz,
    cropped to 1 s), and the overrides of the port's default set ``config``
    (at its full widths) that train one epoch on them."""
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.utils import write_wav
    sr, channels, seconds, offset = TRAIN_DATA[config]
    n_clips = 3 * int(load_config(name=config).datasets.batch_size)
    paths = []
    for i in range(n_clips):
        paths.append(tmp / f'train_{i}.wav')
        write_wav(paths[-1], make_clip(seed + offset + i, batch=1, seconds=seconds, sr=sr,
                                       channels=channels)[0], sr)
    csv = tmp / 'train.csv'
    csv.write_text(''.join(f'{p}\n' for p in paths))
    return [f'datasets.train_csv_path={csv}', 'common.max_epoch=1', 'common.log_interval=1',
            f'common.seed={seed}', 'lr_scheduler.warmup_epoch=0']


def k4_bounds(flops: float, nbytes: float):
    """K4's two bounds in ms, (3xTF32 on the tensor cores, f32 on the CUDA
    cores), each the larger of its operations' time and the bytes' time."""
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(3 * flops / PEAK_TF32_FLOPS, t_bytes),
            1e3 * max(flops / PEAK_F32_FLOPS, t_bytes))


def k4_phase(torch, seed, config_name: str = 'config'):
    """K4 against cuDNN (TF32 off) at the shapes one discriminator call of the
    training config gives it: every conv K4 takes runs forward and dx, and at
    48 kHz, where K5 takes conv_1..conv_3's forward, those convs run K4's dx
    only. Returns the forward and dx summaries over the call."""
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.train.trainer import build_disc_from_config

    config = load_config(name=config_name)
    disc = build_disc_from_config(config, 'cuda', torch.Generator().manual_seed(seed))
    B, length = int(config.datasets.batch_size), int(config.datasets.tensor_cut)
    sr, channels = int(config.model.sample_rate), int(config.model.channels)
    calls = []

    def record(module, args):
        calls.append((args[0].detach(), module.conv.kernel().detach(),
                      module.conv.bias.detach(), module, module.uses_kernel))

    hooks = [m.register_forward_pre_hook(record) for m in disc.modules()
             if getattr(m, 'uses_kernel', False) or getattr(m, 'uses_im2col', False)]
    with torch.no_grad():
        disc(torch.from_numpy(make_clip(seed + 7, B, length / sr, sr, channels)).cuda())
    for h in hooks:
        h.remove()
    check(len(calls) == 12, f'expected 12 eligible convs, found {len(calls)}')
    gen = torch.Generator(device='cuda').manual_seed(seed + 8)
    keys = ('f_ms', 'f_lib', 'f_bound', 'f_bound32', 'f_kern', 'f_pack',
            'd_ms', 'd_lib', 'd_bound', 'd_bound32', 'd_kern', 'd_pack')
    tot = {k: 0.0 for k in keys}
    err_f = err_d = 0.0
    n_fwd = 0
    for x, w, b, m, fwd in calls:
        geo = (m.stride, m.dilation, m.padding)
        y_ref = dck.disc_conv_forward_reference(x, w, b, *geo)
        flops = 2.0 * y_ref.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        line = f'K4 {config_name} x {tuple(x.shape)} w {tuple(w.shape)} stride {m.stride} ' \
               f'dilation {m.dilation}, {flops / 1e9:.2f} GFLOP:'
        if fwd:
            n_fwd += 1
            y = dck.disc_conv_forward(x, w, b, *geo)
            torch.cuda.synchronize()
            ef = float((y - y_ref).abs().max())
            rf = ef / float(y_ref.abs().max())
            wk = dck.pack_weight_cuda(w, m.stride[1], dx=False)
            check(torch.equal(wk, dck.pack_weight(w.permute(1, 2, 3, 0)[None])),
                  f'K4 weight packing disagrees with its plain version at w {tuple(w.shape)}')
            f_ms = cuda_ms(torch, lambda: dck.disc_conv_forward(x, w, b, *geo))
            f_kern = cuda_ms(torch, lambda: dck.forward_packed(x, wk, b, w.shape, *geo))
            f_pack = cuda_ms(torch, lambda: dck.pack_weight_cuda(w, m.stride[1], dx=False))
            f_lib = cuda_ms(torch, lambda: dck.disc_conv_forward_reference(x, w, b, *geo))
            f_bounds = k4_bounds(flops, 4.0 * (x.numel() + w.numel() + b.numel() + y.numel()))
            line += (f' fwd max |d| {ef:.3e} ({rf:.2e} of max), wrapper {f_ms:.4f} ms (kernel '
                     f'{f_kern:.4f} ms, weight packing {f_pack:.4f} ms), cuDNN {f_lib:.4f} ms, '
                     f'bound {f_bounds[0]:.4f} ms (3xTF32) / {f_bounds[1]:.4f} ms (f32);')
            check(rf <= K4_TOL_REL, f'K4 forward disagrees with cuDNN at x {tuple(x.shape)}: {rf}')
            err_f = max(err_f, ef)
            for k, v in zip(keys[:6], (f_ms, f_lib, *f_bounds, f_kern, f_pack)):
                tot[k] += v
            del y
        g = torch.randn(y_ref.shape, generator=gen, device='cuda')
        del y_ref
        dx = dck.disc_conv_input_grad(g, w, x.shape, *geo)
        dx_ref = dck.disc_conv_input_grad_reference(g, w, x.shape, *geo)
        torch.cuda.synchronize()
        ed = float((dx - dx_ref).abs().max())
        rd = ed / float(dx_ref.abs().max())
        wk = dck.pack_weight_cuda(w, m.stride[1], dx=True)
        check(torch.equal(wk, dck.pack_weight(dck.pack_dx_weight(w, m.stride[1]))),
              f'K4 dx weight packing disagrees with its plain version at w {tuple(w.shape)}')
        d_ms = cuda_ms(torch, lambda: dck.disc_conv_input_grad(g, w, x.shape, *geo))
        d_kern = cuda_ms(torch, lambda: dck.input_grad_packed(g, wk, w.shape, x.shape, *geo))
        d_pack = cuda_ms(torch, lambda: dck.pack_weight_cuda(w, m.stride[1], dx=True))
        d_lib = cuda_ms(torch, lambda: dck.disc_conv_input_grad_reference(g, w, x.shape, *geo))
        d_bounds = k4_bounds(flops, 4.0 * (g.numel() + w.numel() + dx.numel()))
        log(f'{line} dx max |d| {ed:.3e} ({rd:.2e} of max), wrapper {d_ms:.4f} ms (kernel '
            f'{d_kern:.4f} ms, weight packing {d_pack:.4f} ms), cuDNN {d_lib:.4f} ms, bound '
            f'{d_bounds[0]:.4f} ms (3xTF32) / {d_bounds[1]:.4f} ms (f32)')
        check(rd <= K4_TOL_REL, f'K4 dx disagrees with cuDNN at x {tuple(x.shape)}: {rd}')
        err_d = max(err_d, ed)
        for k, v in zip(keys[6:], (d_ms, d_lib, *d_bounds, d_kern, d_pack)):
            tot[k] += v
        del dx, dx_ref, g
    log(f'K4 {config_name} over one discriminator call ({n_fwd} forward, {len(calls)} dx): '
        f'forward {tot["f_ms"]:.3f} ms (kernel {tot["f_kern"]:.3f} ms, packing '
        f'{tot["f_pack"]:.3f} ms) vs cuDNN {tot["f_lib"]:.3f} ms (bound {tot["f_bound"]:.3f} ms '
        f'3xTF32, {tot["f_bound32"]:.3f} ms f32); dx {tot["d_ms"]:.3f} ms (kernel '
        f'{tot["d_kern"]:.3f} ms, packing {tot["d_pack"]:.3f} ms) vs cuDNN {tot["d_lib"]:.3f} ms '
        f'(bound {tot["d_bound"]:.3f} ms 3xTF32, {tot["d_bound32"]:.3f} ms f32)')
    fwd, dx = ({'max_abs_err': err, 'ms': tot[p + 'ms'], 'plain_ms': tot[p + 'lib'],
                'bound_ms': tot[p + 'bound'], 'bound_by': 'operations',
                'library_ms': tot[p + 'lib'], 'bound_f32_ms': tot[p + 'bound32'],
                'kernel_ms': tot[p + 'kern'], 'packing_ms': tot[p + 'pack']}
               for p, err in (('f_', err_f), ('d_', err_d)))
    return fwd, dx


def k5_phase(torch, seed, before=None):
    """K5 against its plain version (the im2col GEMM) and cuDNN's ``F.conv2d``
    at the 9 F-stride-2 conv shapes of one discriminator call at the 48 kHz
    training config, forward and the trainable route's dx and dW; beside it,
    K4's forward and (with ``before``) the other checkout's K5 on the same
    inputs. Returns the summary over the 9 convs, each shape under
    ``shapes``."""
    import torch.nn.functional as F

    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
    from encodec_pytorch_tpu_torch.train.trainer import build_disc_from_config

    config = load_config(name='config_48k_stereo')
    disc = build_disc_from_config(config, 'cuda', torch.Generator().manual_seed(seed))
    B, length = int(config.datasets.batch_size), int(config.datasets.tensor_cut)
    calls = []

    def record(module, args):
        calls.append((args[0].detach(), module.conv.kernel().detach(),
                      module.conv.bias.detach(), module))

    hooks = [m.register_forward_pre_hook(record) for m in disc.modules()
             if getattr(m, 'uses_im2col', False)]
    with torch.no_grad():
        disc(torch.from_numpy(make_clip(seed + 17, B, length / SR48, SR48, 2)).cuda())
    for h in hooks:
        h.remove()
    check(len(calls) == 9, f'expected 9 F-stride-2 convs, found {len(calls)}')
    gen = torch.Generator(device='cuda').manual_seed(seed + 18)
    keys = ('ms', 'device_ms', 'kernel_ms', 'packing_ms', 'plain_ms', 'library_ms', 'k4_ms',
            'bound_ms', 'bound_f32_ms', 'gflop') + (('before_ms',) if before is not None else ())
    tot = {k: 0.0 for k in keys}
    worst = worst_grad = 0.0
    shapes = []
    for x, w, b, m in calls:
        geo = (m.dilation, m.padding)
        y = k5.disc_im2col_forward(x, w, b, *geo)
        y_plain = k5.disc_im2col_forward_plain(x, w, b, *geo)
        y_lib = F.conv2d(x, w, b, stride=k5.STRIDE, padding=m.padding, dilation=m.dilation)
        torch.cuda.synchronize()
        top = float(y_lib.abs().max())
        e_plain = float((y - y_plain).abs().max())
        e_lib = float((y - y_lib).abs().max())
        del y_plain
        same = bool(torch.equal(y, k5.disc_im2col_forward(x, w, b, *geo)))
        wk = k5.pack_weight_cuda(w)
        check(torch.equal(wk, k5.pack_weight(w)),
              f'K5 weight packing disagrees with its plain version at x {tuple(x.shape)}')
        # the trainable route (K5, K4's dx, cuDNN's dW) against F.conv2d's autograd
        g = torch.randn(y.shape, generator=gen, device='cuda')
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        got = torch.autograd.grad(k5.disc_im2col(xr, wr, b, *geo), (xr, wr), g)
        ref = torch.autograd.grad(F.conv2d(xr, wr, b, stride=k5.STRIDE, padding=m.padding,
                                           dilation=m.dilation), (xr, wr), g)
        e_grad = [float((a - r).abs().max()) / float(r.abs().max()) for a, r in zip(got, ref)]
        del got, ref, xr, wr, g
        row = dict(x=list(x.shape), dilation=list(m.dilation))
        row['ms'] = cuda_ms(torch, lambda: k5.disc_im2col_forward(x, w, b, *geo))
        row['device_ms'] = device_ms(torch, lambda: k5.disc_im2col_forward(x, w, b, *geo),
                                     'disc_im2col_kernel')
        row['kernel_ms'] = cuda_ms(torch, lambda: k5.forward_packed(x, wk, b, *geo))
        row['packing_ms'] = cuda_ms(torch, lambda: k5.pack_weight_cuda(w))
        row['plain_ms'] = cuda_ms(torch, lambda: k5.disc_im2col_forward_plain(x, w, b, *geo),
                                  runs=5)
        row['library_ms'] = cuda_ms(torch, lambda: F.conv2d(
            x, w, b, stride=k5.STRIDE, padding=m.padding, dilation=m.dilation))
        row['k4_ms'] = cuda_ms(torch, lambda: dck.disc_conv_forward(x, w, b, k5.STRIDE, *geo))
        flops = 2.0 * y.numel() * w[0].numel()
        row['bound_ms'], row['bound_f32_ms'] = k4_bounds(
            flops, 4.0 * (x.numel() + w.numel() + b.numel() + y.numel()))
        row['gflop'] = flops / 1e9
        row['rel_err'] = max(e_plain, e_lib) / top
        line = (f'K5 disc_im2col x {tuple(x.shape)} dilation {m.dilation}, '
                f'{row["gflop"]:.2f} GFLOP: max |d| vs plain {e_plain:.3e}, vs cuDNN '
                f'{e_lib:.3e} ({row["rel_err"]:.2e} of max); bit-equal on a repeat: {same}; '
                f'autograd dx, dW vs cuDNN {e_grad[0]:.2e}, {e_grad[1]:.2e} of max; wrapper '
                f'{row["ms"]:.4f} ms (on the device {fmt_ms(row["device_ms"])}; kernel '
                f'{row["kernel_ms"]:.4f} ms, weight packing {row["packing_ms"]:.4f} ms), plain '
                f'(im2col GEMM) {row["plain_ms"]:.4f} ms, cuDNN F.conv2d '
                f'{row["library_ms"]:.4f} ms, K4 forward {row["k4_ms"]:.4f} ms, bound '
                f'{row["bound_ms"]:.4f} ms (3xTF32) / {row["bound_f32_ms"]:.4f} ms (f32)')
        if before is not None:
            bk5 = before.disc_im2col_kernel
            y_before = bk5.disc_im2col_forward(x, w, b, *geo)
            row['before_ms'] = cuda_ms(torch, lambda: bk5.disc_im2col_forward(x, w, b, *geo))
            row['before_rel_d'] = float((y - y_before).abs().max()) / top
            line += (f'; the earlier kernel {row["before_ms"]:.4f} ms, max |d| between the two '
                     f'{row["before_rel_d"]:.2e} of max')
            del y_before
        log(line)
        check(row['rel_err'] <= K5_TOL_REL and max(e_grad) <= K5_TOL_REL and same,
              f'K5 disagrees at x {tuple(x.shape)}: {e_plain}, {e_lib}, {e_grad}, repeat {same}')
        worst = max(worst, e_plain, e_lib)
        worst_grad = max(worst_grad, *e_grad)
        for k in keys:
            tot[k] += row[k] if row[k] is not None else float('nan')
        shapes.append(row)
        del y, y_lib
    log(f'K5 over one discriminator call (9 convs, {tot["gflop"]:.1f} GFLOP): wrapper '
        f'{tot["ms"]:.3f} ms (on the device {fmt_ms(tot["device_ms"])}; kernel '
        f'{tot["kernel_ms"]:.3f} ms, packing {tot["packing_ms"]:.3f} ms), plain '
        f'{tot["plain_ms"]:.3f} ms, cuDNN {tot["library_ms"]:.3f} ms, K4 forward '
        f'{tot["k4_ms"]:.3f} ms, bound {tot["bound_ms"]:.3f} ms (3xTF32) / '
        f'{tot["bound_f32_ms"]:.3f} ms (f32); worst autograd error {worst_grad:.2e} of max'
        + (f'; the earlier kernel {tot["before_ms"]:.3f} ms' if before is not None else ''))
    return dict(max_abs_err=worst, **{k: v for k, v in tot.items() if k != 'gflop'},
                bound_by='operations', shapes=shapes)


def read_frames(model, data: bytes):
    """(header, [(scale or None, codes [K, T'])]) of a packed ``.ecdc``."""
    import math
    import struct

    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.bitstream.binary import read_ecdc_header
    fo = io.BytesIO(data)
    meta = read_ecdc_header(fo)
    frames = []
    offsets = range(0, meta['al'], model.segment_stride or meta['al'])
    for offset in offsets:
        this = min(meta['al'] - offset, model.segment_length or meta['al'])
        fr = meta['fr'] if len(offsets) == 1 else math.ceil(this * model.frame_rate
                                                             / model.sample_rate)
        scale = struct.unpack('!f', fo.read(4))[0] if model.normalize else None
        frames.append((scale, C._decompress_frame_packed(model, fo, meta['nc'], fr)))
    check(fo.read() == b'', 'bytes left after the last frame')
    return meta, frames


def codec48_phase(torch, seed, tmp: Path):
    """The 48 kHz codec CLI at full ``encodec_48khz`` width: 10 s stereo to
    ``.ecdc`` and back at 6 and 24 kbps; returns the K1, K2, K3 launch counts
    of the CLI run."""
    from encodec_pytorch_tpu_torch import cli
    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.models.model import encodec_model_48khz
    from encodec_pytorch_tpu_torch.utils import read_wav, write_wav

    ckpt = tmp / CKPT48
    write_seeded_checkpoint(torch, seed + 40, ckpt, 'encodec_48khz')
    wav_in, ecdc, wav_out = tmp / 'in48.wav', tmp / 'out48.ecdc', tmp / 'out48.wav'
    write_wav(wav_in, make_clip(seed + 41, 1, SECONDS, SR48, 2)[0], SR48)
    common = ['-q', '-c', str(ckpt), '--device', 'cuda', '-f']

    reset_counts()
    t0 = time.perf_counter()
    cli.main([str(wav_in), str(ecdc), '-b', '6', *common])
    cli.main([str(ecdc), str(wav_out), *common])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    log(f'48 kHz: CLI -q compress + decompress of {SECONDS} s stereo in {cli_s:.2f} s (model '
        f'loads included); kernel launches {launches}')
    check(launches['rvq_encode'] > 0 and launches['lstm_recurrence'] > 0,
          f'the 48 kHz codec path did not go through K1 and K2: {launches}')
    check(launches['resblock'] == 0, f'a time_group_norm resblock took K3: {launches}')

    model = encodec_model_48khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    data = ecdc.read_bytes()
    meta, frames = read_frames(model, data)
    lengths = [c.shape[1] for _, c in frames]
    log(f'48 kHz: .ecdc {len(data)} bytes, header {meta}, {len(frames)} frames of code lengths '
        f'{lengths}, scales {[round(sc, 5) for sc, _ in frames]}')
    check(meta['m'] == 'encodec_48khz' and meta['al'] == SR48 * SECONDS and meta['nc'] == 4
          and meta['lm'] is False, f'bad header {meta}')
    check(len(frames) == 11 and lengths[:-1] == [150] * 10 and lengths[-1] == 15
          and all(sc is not None and sc > 0 for sc, _ in frames), 'bad frames')
    out, sr = read_wav(wav_out)
    check(sr == SR48 and out.shape == (2, SR48 * SECONDS) and np.isfinite(out).all(),
          f'bad output wav {out.shape} at {sr} Hz')

    wav, _ = read_wav(wav_in)
    x = torch.from_numpy(wav[None]).cuda()
    enc = model.encode(x)
    check(all(np.array_equal(fc, c[0].cpu().numpy()) and np.float32(sc) == float(s[0, 0])
              for (sc, fc), (c, s) in zip(frames, enc)),
          'the .ecdc codes or scales differ from the in-process encode')
    dec = model.decode(enc)[0, :, :SR48 * SECONDS].cpu().numpy()
    check(np.abs(out - np.clip(dec, -0.99, 0.99)).max() <= 2 / 32768,
          "the CLI's wav differs from the in-process decode")
    with plain_path():
        enc_p = model.encode(x)
        dec_p = model.decode(enc_p)[0, :, :SR48 * SECONDS].cpu().numpy()
    codes, codes_p = (torch.cat([c for c, _ in e], -1) for e in (enc, enc_p))
    same = float((codes == codes_p).float().mean())
    snr = snr_db(dec_p, dec)
    sm = model.encode_segmajor(x)
    same_sm = float((codes == torch.cat([c for c, _ in sm], -1)).float().mean())
    log(f'48 kHz 6 kbps: identical codes kernel vs plain {same:.6f}, decode SNR kernel vs plain '
        f'{snr:.2f} dB, encode_segmajor vs encode {same_sm:.6f}; distinct codes used '
        f'{len(torch.unique(codes))}')
    check(same >= K1_TOL_SHARE and snr >= SNR_MIN_DB and same_sm >= K1_TOL_SHARE,
          '48 kHz kernel path disagrees with plain path or segment-major encode')

    def round_trip():
        return C.decompress(model, C.compress(model, wav))

    round_trip()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_trip()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t1 = statistics.median(times)
    log(f'48 kHz RTF round trip (compress + decompress, B=1, {SECONDS} s stereo): '
        f'{SECONDS / t1:.2f} (median {t1 * 1000:.1f} ms of 3)')

    model.set_target_bandwidth(24.)
    data24 = C.compress(model, wav)
    meta24, frames24 = read_frames(model, data24)
    out24, _ = C.decompress(model, data24)
    enc24 = model.encode(x)
    with plain_path():
        enc24_p = model.encode(x)
    same24 = float((torch.cat([c for c, _ in enc24], -1)
                    == torch.cat([c for c, _ in enc24_p], -1)).float().mean())
    log(f'48 kHz 24 kbps: header nc {meta24["nc"]}, {len(data24)} bytes, {len(frames24)} frames, '
        f'identical codes kernel vs plain {same24:.6f}')
    check(meta24['nc'] == 16 and len(frames24) == 11 and out24.shape == (2, SR48 * SECONDS)
          and np.isfinite(out24).all() and same24 >= K1_TOL_SHARE, '48 kHz 24 kbps run failed')
    return launches


def server48_phase(torch, seed, ckpt: Path):
    """A CodecServer on the 48 kHz model (segment-major by default): 8
    concurrent stereo round trips of 1.5-10 s in four pairs of lengths;
    returns the K1, K2, K3 launch counts of the served requests."""
    import threading

    from encodec_pytorch_tpu_torch.models.model import encodec_model_48khz
    from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec

    model = encodec_model_48khz(checkpoint=ckpt, device='cuda')
    codec = LiveCodec(model, default_bandwidth=6., device='cuda')
    check(codec.segment_major, 'the 48 kHz LiveCodec is not segment-major')
    lengths = [72000, 144000, 288000, 480000] * 2
    reqs = [make_clip(seed + 600 + i, 1, n / SR48, SR48, 2)[0] for i, n in enumerate(lengths)]
    direct = [codec.roundtrip(r[None])[0].cpu().numpy() for r in reqs]
    results = [None] * len(reqs)
    reset_counts()
    with CodecServer(codec, max_batch=8, max_wait_ms=50.0) as cs:
        def call(i):
            results[i] = cs.roundtrip(reqs[i], timeout=120)
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        cstats = cs.stats()
    launches = read_counts()
    check(all(r is not None for r in results), 'a CodecServer request did not finish')
    snrs = []
    for r, d, n in zip(results, direct, lengths):
        check(r.shape == (2, n), f'CodecServer result {r.shape} for {n} samples')
        snrs.append(snr_db(d, r))
    log(f'48 kHz serving: CodecServer 8 concurrent stereo round trips of {sorted(set(lengths))} '
        f'samples, 2 each: {cstats["batches"]} batches, mean batch {cstats["mean_batch"]:.2f}, '
        f'latency ms p50 {cstats["latency_p50_ms"]:.2f}, {sum(lengths) / SR48:.1f} audio s in '
        f'{wall:.3f} s; vs direct calls min SNR {min(snrs):.2f} dB; kernel launches {launches}')
    check(min(snrs) >= SNR_MIN_DB and cstats['batches'] < len(reqs),
          '48 kHz CodecServer results disagree with direct calls, or nothing coalesced')
    check(launches['resblock'] == 0, f'a time_group_norm resblock took K3: {launches}')
    return launches


def _flat(module, grads: bool):
    import torch
    return torch.cat([(p.grad if grads else p.detach()).reshape(-1)
                      for p in module.parameters()])


def training_phase(torch, seed, tmp: Path, config: str = 'config'):
    """The training path of the default set ``config`` and its kernel-vs-plain
    step: returns the kernels' launch counts on the training path."""
    import copy

    from encodec_pytorch_tpu_torch import train_cli
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
    from encodec_pytorch_tpu_torch.ops import lstm_kernel
    from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step
    from encodec_pytorch_tpu_torch.train.trainer import (build_disc_from_config,
                                                         build_model_from_config)

    sr, channels, _, _ = TRAIN_DATA[config]
    overrides = train_overrides(tmp, seed, config)
    entries = {'disc_conv_forward': dck.disc_conv_forward,
               'disc_conv_input_grad': dck.disc_conv_input_grad,
               'lstm_recurrence': lstm_kernel.lstm_recurrence}
    if config != 'config':
        entries['disc_im2col_forward'] = k5.disc_im2col_forward
    torch.cuda.reset_peak_memory_stats()
    for fn in entries.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = train_cli.main(['--device', 'cuda', '--config', config, *overrides])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in entries.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = trainer.history[-1]
    step_ms = summary['step_ms']
    log(f'training {config}: train_cli, {summary["steps"]} steps of '
        f'{trainer.config.datasets.batch_size} x {channels} x {trainer.tensor_cut} in '
        f'{wall:.2f} s (set-up included); ms per step '
        f'{[round(t, 1) for t in step_ms]}, median after the first '
        f'{statistics.median(step_ms[1:]):.1f} ms; peak memory {peak_gb:.2f} GB; '
        f'kernel launches {launches}')
    log(f'training {config}: epoch means ' + json.dumps(
        {k: v for k, v in summary.items() if k not in ('step_ms', 'steps')}))
    check(summary['steps'] == 3, f'expected 3 steps, ran {summary["steps"]}')
    check(all(v > 0 for v in launches.values()),
          f'the training path did not go through every kernel: {launches}')
    check(all(np.isfinite(v) for k, v in summary.items() if k not in ('step_ms', 'steps')),
          'non-finite training metrics')
    check(summary['disc_updated'] == 1.0, 'the discriminator was not updated')

    init = torch.Generator().manual_seed(int(trainer.config.common.seed))
    model0 = build_model_from_config(trainer.config, 'cuda', init)
    disc0 = build_disc_from_config(trainer.config, 'cuda', init)
    moved = {
        'generator': float((_flat(trainer.model, False) - _flat(model0, False)).abs().max()),
        'discriminator': float((_flat(trainer.disc, False) - _flat(disc0, False)).abs().max()),
        'codebooks': float((trainer.model.quantizer.vq.embeds(trainer.model.quantizer.n_q)
                            - model0.quantizer.vq.embeds(model0.quantizer.n_q)).abs().max()),
    }
    log(f'training {config}: max |change| of the parameters from their seeded init {moved}')
    check(all(v > 0 and np.isfinite(v) for v in moved.values()), f'not everything trained: {moved}')

    # the most stages whose k-means init already ran, so that both runs start
    # from the same codebooks
    inited = [bool(layer._codebook.inited) for layer in trainer.model.quantizer.vq.layers]
    n_q = max(n for n in trainer.n_q_table if all(inited[:n]))
    log(f'training {config}: the kernel-vs-plain step runs at n_q {n_q}')

    def one_step(plain: bool):
        model, disc = copy.deepcopy(trainer.model), copy.deepcopy(trainer.disc)
        opt_g, opt_d = make_optimizer(model.parameters()), make_optimizer(disc.parameters())
        # deep copies: load_state_dict keeps the very state tensors it is given
        opt_g.load_state_dict(copy.deepcopy(trainer.opt_g.state_dict()))
        opt_d.load_state_dict(copy.deepcopy(trainer.opt_d.state_dict()))
        batch = torch.from_numpy(make_clip(seed + 9, int(trainer.config.datasets.batch_size),
                                           trainer.tensor_cut / sr, sr, channels)).cuda()
        before = _flat(model, False), _flat(disc, False)
        with plain_path() if plain else contextlib.nullcontext():
            metrics = train_step(model, disc, copy.deepcopy(trainer.balancer), opt_g, opt_d,
                                 batch, n_q=n_q, train_disc=True, lr_g=3e-4, lr_d=3e-4,
                                 sample_rate=sr,
                                 generator=torch.Generator(device='cuda').manual_seed(seed))
        return ({k: float(v) for k, v in metrics.items()},
                (_flat(model, True), _flat(disc, True)),
                (_flat(model, False) - before[0], _flat(disc, False) - before[1]))

    m_k, g_k, u_k = one_step(plain=False)
    m_p, g_p, u_p = one_step(plain=True)
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    loss_rel = {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-30)
                for k in ('l_t', 'l_f', 'l_g', 'l_feat', 'loss_w', 'loss_disc')}
    grad_rel = [rel(a, b) for a, b in zip(g_k, g_p)]
    upd_rel = [rel(a, b) for a, b in zip(u_k, u_p)]
    log(f'training {config}: one step kernels vs plain from the trained state: loss relative '
        f'diffs {loss_rel}; gradient relative norm diffs (generator, discriminator) '
        f'{grad_rel}; update relative norm diffs {upd_rel}')
    check(all(v <= TRAIN_LOSS_REL for v in loss_rel.values())
          and all(v <= TRAIN_GRAD_REL for v in grad_rel)
          and all(v <= TRAIN_UPDATE_REL for v in upd_rel),
          'the kernel step disagrees with the plain step')
    return launches


def run(seed: int, before_dir=None) -> int:
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this check runs only on the GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from encodec_pytorch_tpu_torch.ops import _build, lstm_kernel, rvq_kernel
    except ImportError as e:
        print(f'chip_smoke: run from the root of a checkout ({e})', file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(f'device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, '
        f'cudnn {torch.backends.cudnn.allow_tf32}')

    _build.load()
    log(f'build: {_build.BuildInfo.seconds:.2f} s (nvcc ran: {_build.BuildInfo.compiled}) '
        f'-> {_build.BuildInfo.path}')
    for line in _build.BuildInfo.log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            log(f'  ptxas: {line.strip()}')

    before = None
    if before_dir is not None:
        before = load_before(before_dir)
        before._build.load()
        log(f'--before {before_dir}: built in {before._build.BuildInfo.seconds:.2f} s -> '
            f'{before._build.BuildInfo.path}')
    gen = torch.Generator(device='cuda').manual_seed(seed)
    phase('K1')
    k1 = k1_phase(torch, rvq_kernel, gen, before)
    phase('K2')
    k2 = k2_phase(torch, lstm_kernel, gen)
    with tempfile.TemporaryDirectory() as tmp:
        phase('codec CLI')
        cli_launches = main_path_phase(torch, seed, Path(tmp))
        phase('K3')
        k3 = k3_phase(torch, seed, Path(tmp) / CKPT, before)
        phase('serving')
        serve_launches = serving_phase(torch, seed, Path(tmp) / CKPT)
    launches = {k: cli_launches[k] + serve_launches[k] for k in CODEC_KERNELS}
    phase('K4')
    k4_fwd, k4_dx = k4_phase(torch, seed)
    with tempfile.TemporaryDirectory() as tmp:
        phase('training')
        train_launches = training_phase(torch, seed, Path(tmp))
    phase('K4 at 48 kHz')
    k4_fwd48, k4_dx48 = k4_phase(torch, seed, 'config_48k_stereo')
    for summary, at48 in ((k4_fwd, k4_fwd48), (k4_dx, k4_dx48)):
        summary['shapes'] = [dict(summary, config='config'), dict(at48, config='config_48k_stereo')]
        summary['max_abs_err'] = max(summary['max_abs_err'], at48['max_abs_err'])
    phase('K5')
    k5 = k5_phase(torch, seed, before)
    with tempfile.TemporaryDirectory() as tmp:
        phase('48 kHz codec CLI')
        cli48_launches = codec48_phase(torch, seed, Path(tmp))
        phase('48 kHz CodecServer')
        serve48_launches = server48_phase(torch, seed, Path(tmp) / CKPT48)
    for k in CODEC_KERNELS:
        launches[k] += cli48_launches[k] + serve48_launches[k]
    with tempfile.TemporaryDirectory() as tmp:
        phase('48 kHz training')
        train48_launches = training_phase(torch, seed, Path(tmp), 'config_48k_stereo')
    phase('done')

    k4_src = 'encodec_pytorch_tpu_torch/csrc/disc_conv.cu'
    k4_tpu = 'encodec_pytorch_tpu/ops/pallas_conv2d_v2.py:114'
    kernels = [
        dict(name='rvq_encode', route='cuda', source='encodec_pytorch_tpu_torch/csrc/rvq.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_vq.py:31',
             launches=launches['rvq_encode'], **k1),
        dict(name='lstm_recurrence', route='cuda',
             source='encodec_pytorch_tpu_torch/csrc/lstm.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_lstm.py:22',
             launches=launches['lstm_recurrence'], **k2),
        dict(name='resblock', route='cuda', source='encodec_pytorch_tpu_torch/csrc/resblock.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_resblock.py:34',
             launches=launches['resblock'], **k3),
        dict(name='disc_conv_forward', route='cuda', source=k4_src, replaces=k4_tpu,
             launches=train_launches['disc_conv_forward']
             + train48_launches['disc_conv_forward'], **k4_fwd),
        dict(name='disc_conv_input_grad', route='cuda', source=k4_src, replaces=k4_tpu,
             launches=train_launches['disc_conv_input_grad']
             + train48_launches['disc_conv_input_grad'], **k4_dx),
        dict(name='disc_im2col_forward', route='cuda',
             source='encodec_pytorch_tpu_torch/csrc/disc_im2col.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_conv2d.py:42',
             launches=train48_launches['disc_im2col_forward'], **k5),
    ]
    log(json.dumps({'kernels': kernels}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--before', type=Path, default=None,
                        help='another checkout of the port (e.g. the parent commit): the K1, '
                             'K3 and K5 phases also time its kernels and compare their outputs')
    args = parser.parse_args()
    try:
        return run(args.seed, args.before)
    except (Exception, SystemExit) as e:   # any phase's failure fails the run
        traceback.print_exc()
        print(f'chip_smoke: FAILED: {e!r}', file=sys.stderr)
        return 1


if __name__ == '__main__':
    sys.exit(main())
