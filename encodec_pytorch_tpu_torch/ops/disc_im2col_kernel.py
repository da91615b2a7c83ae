"""Discriminator im2col conv: the CUDA kernel K5 (``csrc/disc_im2col.cu``; in
bf16 ``csrc/disc_im2col_bf16.cu``), its plain version, and the trainable
conv built on it.

Port of ``encodec_pytorch_tpu/ops/pallas_conv2d.py`` (``conv2d_im2col``, the
im2col GEMM ``W[32, 864] @ X[864, N]``), in torch's NCHW layout with H = STFT
frames (time) and W = frequency bins: ``x [B, Cin, T, F]``,
``w [Cout, Cin, KT, KF]``, F-stride 2, T-stride 1, T dilation ``dt``, no F
dilation, zero padding ``(pt, pf)``. The JAX package wires its kernel nowhere
(only its tests and ``scripts/bench_disc_conv.py`` call it); the port puts K5
on the forward of the discriminator's ``conv_1``..``conv_3`` when the config
key ``tpu.disc_im2col`` is set.

- :func:`disc_im2col_forward_plain` — the im2col GEMM in torch: ``X[(mt, mf,
  ci), n]`` gathered from the padded input, then one ``matmul`` with the
  weights as ``[Cout, KT·KF·Cin]``. It takes any channel and tap count, and is
  deliberately not ``F.conv2d``: the CPU tests hold the TPU kernel's
  arithmetic.
- :func:`disc_im2col_forward` — the forward; kernel K5 on CUDA (32 → 32
  channels, 3×9 taps), the plain version on the CPU.
- :func:`disc_im2col` — the trainable conv, a ``torch.autograd.Function``:
  K5 forward; backward: K4's input-gradient entry
  (:func:`.disc_conv_kernel.disc_conv_input_grad`) and
  ``torch.nn.grad.conv2d_weight`` for dW, the split K4's route uses. On the
  CPU the same function runs the plain versions.

K5 runs on the tensor cores in 3xTF32, as K4 does: each operand is split
into two TF32 parts (:func:`.disc_conv_kernel.split_tf32`) and each term is
the sum of three TF32 products, within 1e-5 of the f32 conv's largest value.
:func:`pack_weight` splits the weights and lays them out as the B images of
the kernel's ``wgmma`` k-steps; on the card :func:`pack_weight_cuda` does the
same in one launch, once a call.

K5 takes float32 or bfloat16, as the TPU kernel takes its input's dtype. In
bfloat16 (:func:`disc_im2col_forward_bf16`, ``csrc/disc_im2col_bf16.cu``) it
is ``wgmma`` of bf16 products with both operands in shared memory, fed by
producer warps that lay the window out channels-last, in persistent CTAs;
the products are summed in f32, the sum rounded to bf16 and the bias added
after that rounding, in bf16 (``ops/conv.py:263``). It takes T dilations 1,
2 and 4 only (the discriminator's). The weights are laid out by
:func:`pack_weight_bf16` (one launch on the card), each k-step pairing two
taps in the order of their staged addresses (:data:`TAP_ORDER_BF16`), and
the plain version is the same im2col GEMM in f32 on the bf16 operands,
rounded to bf16, then the bias added in bf16.

For a CUDA tensor the wrapper launches the kernel of the tensors' dtype, or
raises on a dtype, shape or stride it does not take (a bf16 call never
reaches cuDNN or the f32 kernel); ``disc_im2col_forward.launches`` and
``disc_im2col_forward_bf16.launches`` count the launches. The TPU kernel's t-major phase split, 8-row blocks and 128-lane
padding are not carried over: the design is in the source's head comment.
"""

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, disc_conv_kernel

Pair = Tuple[int, int]

STRIDE = (1, 2)
CHANNELS = 32
TAPS = (3, 9)
T_DILATIONS = (1, 2, 4)
# the kernel's reduction (csrc/disc_im2col.cu): chunks of 4 input channels,
# k-steps of those 4 channels at two taps (the 28th tap zero), and a k-step's
# B image of 32 output channels x 8 k
CHUNK = 4
STEPS = -(-TAPS[0] * TAPS[1] // 2)
B_IMAGE = CHANNELS * 8
# the bf16 kernel (csrc/disc_im2col_bf16.cu): chunks of 8 channels, k-steps
# of 16 (8 channels at two taps), a B image of 32 output channels x 16 k; the
# taps (mt * 9 + mf) in the order of their staged addresses: each row mt's
# even mf (staged first), then its odd ones
CHUNK_BF16 = 8
B_IMAGE_BF16 = CHANNELS * 16
TAP_ORDER_BF16 = tuple(mt * TAPS[1] + mf for mt in range(TAPS[0])
                       for mf in list(range(0, TAPS[1], 2)) + list(range(1, TAPS[1], 2)))


def eligible(in_channels: int, out_channels: int, kernel_size: Pair, stride: Pair,
             dilation: Pair, padding: Pair) -> bool:
    """The convs K5 takes: 32 → 32 channels, 3×9 taps, F-stride 2, T-stride
    1, no F dilation, T dilation 1, 2 or 4 (``conv_1``..``conv_3`` of each
    discriminator scale)."""
    return (in_channels == CHANNELS and out_channels == CHANNELS
            and tuple(kernel_size) == TAPS and tuple(stride) == STRIDE
            and dilation[1] == 1 and dilation[0] in T_DILATIONS and min(padding) >= 0)


def disc_im2col_forward_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                              dilation: Pair, padding: Pair) -> torch.Tensor:
    """Plain forward: ``X[b, (mt, mf, ci), (t, f)] = xpad[b, ci, t + mt·dt,
    2f + mf]``, then ``W[Cout, (mt, mf, ci)] @ X`` in f32, rounded to x's
    dtype, plus the bias in that dtype."""
    B, Cin, T, F_ = x.shape
    Cout, _, KT, KF = w.shape
    dt, pt, pf = dilation[0], padding[0], padding[1]
    To, Fo = disc_conv_kernel.out_size(T, F_, KT, KF, STRIDE[1], dt, pt, pf)
    xp = F.pad(x, (pf, pf, pt, pt))
    cols = [xp[:, :, mt * dt:mt * dt + To, mf:mf + STRIDE[1] * (Fo - 1) + 1:STRIDE[1]]
            for mt in range(KT) for mf in range(KF)]                  # each [B, Cin, To, Fo]
    X = torch.stack(cols, 1).reshape(B, KT * KF * Cin, To * Fo)
    wk = w.permute(0, 2, 3, 1).reshape(Cout, KT * KF * Cin)
    y = torch.matmul(wk.float(), X.float()).reshape(B, Cout, To, Fo).to(x.dtype)
    return y if bias is None else y + bias.reshape(1, Cout, 1, 1)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand, from ``w [32, 32, 3, 9]``: split by
    :func:`.disc_conv_kernel.split_tf32` and laid out as ``[Cin / 4, STEPS,
    2, B_IMAGE]``: chunk of 4 input channels, k-step, part (hi, lo), and the
    k-step's B image in ``wgmma``'s K-major layout without swizzle, where
    element ``(co, k)`` sits at ``(co // 8)·64 + (k // 4)·32 + (co % 8)·4 +
    k % 4`` and is ``w[co, 4·chunk + k % 4, tap // 9, tap % 9]`` with ``tap =
    2·step + k // 4`` (zero at tap 27)."""
    Cout, Cin, KT, KF = w.shape
    taps = KT * KF
    wt = F.pad(w.reshape(Cout, Cin, taps), (0, 2 * STEPS - taps))
    # co-block, co % 8, chunk, c, step, tap of the pair
    wt = wt.reshape(Cout // 8, 8, Cin // CHUNK, CHUNK, STEPS, 2)
    wt = wt.permute(2, 4, 0, 5, 1, 3).reshape(Cin // CHUNK, STEPS, 1, B_IMAGE)
    hi, lo = disc_conv_kernel.split_tf32(wt.contiguous())
    return torch.cat([hi, lo], 2).contiguous()


def pack_weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's weight operand, from ``w [32, 32, 3, 9]`` (bf16),
    laid out as ``[Cin / 8, STEPS, B_IMAGE_BF16]``: chunk of 8 input channels,
    k-step, and the k-step's B image in ``wgmma``'s K-major layout without
    swizzle (core matrices of 8 channels x 8 k), where element ``(co, k)``
    sits at ``(co // 8)·128 + (k // 8)·64 + (co % 8)·8 + k % 8`` and is
    ``w[co, 8·chunk + k % 8, tap // 9, tap % 9]`` with ``tap =
    TAP_ORDER_BF16[2·step + k // 8]`` (zero past the 27th). No rounding: the
    values are moved."""
    Cout, Cin, KT, KF = w.shape
    taps = KT * KF
    wt = w.reshape(Cout, Cin, taps)[:, :, list(TAP_ORDER_BF16)]
    wt = F.pad(wt, (0, 2 * STEPS - taps))
    # co-block, co % 8, chunk, c, step, tap of the pair
    wt = wt.reshape(Cout // 8, 8, Cin // CHUNK_BF16, CHUNK_BF16, STEPS, 2)
    return wt.permute(2, 4, 0, 5, 1, 3).reshape(Cin // CHUNK_BF16, STEPS,
                                                B_IMAGE_BF16).contiguous()


def pack_weight_cuda(w: torch.Tensor) -> torch.Tensor:
    """:func:`pack_weight` (float32 ``w``) or :func:`pack_weight_bf16`
    (bfloat16 ``w``) in one launch on the card, from ``w`` (contiguous, on
    CUDA). The same bits as the plain version."""
    stream = torch.cuda.current_stream(w.device).cuda_stream
    lib = _build.load()
    if w.dtype == torch.bfloat16:
        out = torch.empty(CHANNELS // CHUNK_BF16, STEPS, B_IMAGE_BF16, device=w.device,
                          dtype=torch.bfloat16)
        entry = lib.encodec_disc_im2col_pack_bf16
    else:
        out = torch.empty(CHANNELS // CHUNK, STEPS, 2, B_IMAGE, device=w.device,
                          dtype=torch.float32)
        entry = lib.encodec_disc_im2col_pack_f32
    rc = entry(w.data_ptr(), out.data_ptr(), ctypes.c_void_p(stream))
    _build.check(rc, 'disc_im2col weight-packing kernel')
    return out


def disc_im2col_forward(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                        dilation: Pair, padding: Pair) -> torch.Tensor:
    """The conv's forward at F-stride 2; kernel K5 on CUDA (bfloat16 inputs:
    :func:`disc_im2col_forward_bf16`)."""
    if x.device.type == 'cpu' and w.device.type == 'cpu':
        return disc_im2col_forward_plain(x, w, bias, dilation, padding)
    if x.dtype == torch.bfloat16:
        return disc_im2col_forward_bf16(x, w, bias, dilation, padding)
    y = _forward_checked('disc_im2col_forward', x, w, bias, dilation, padding, torch.float32)
    disc_im2col_forward.launches += 1
    return y


def disc_im2col_forward_bf16(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                             dilation: Pair, padding: Pair) -> torch.Tensor:
    """The conv's forward at F-stride 2 in bf16 (x, w and bias bf16): K5's
    bf16 kernel on CUDA, the plain version on the CPU."""
    if x.device.type == 'cpu' and w.device.type == 'cpu':
        return disc_im2col_forward_plain(x, w, bias, dilation, padding)
    y = _forward_checked('disc_im2col_forward_bf16', x, w, bias, dilation, padding,
                         torch.bfloat16)
    disc_im2col_forward_bf16.launches += 1
    return y


def _forward_checked(what: str, x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                     dilation: Pair, padding: Pair, dtype: torch.dtype) -> torch.Tensor:
    disc_conv_kernel._check_cuda(what, x, w, bias, dtype=dtype)
    Cout, Cin, KT, KF = w.shape
    if (Cin, Cout) != (CHANNELS, CHANNELS) or (KT, KF) != TAPS or dilation[1] != 1:
        raise ValueError(f'disc_im2col kernel: built for {CHANNELS} -> {CHANNELS} channels, '
                         f'{TAPS} taps and no F dilation, got w {tuple(w.shape)}, '
                         f'dilation {dilation}')
    dt, pt, pf = dilation[0], padding[0], padding[1]
    if dt < 1 or min(pt, pf) < 0:
        raise ValueError(f'disc_im2col kernel: bad dilation {dilation} or padding {padding}')
    if dtype == torch.bfloat16 and dt not in T_DILATIONS:
        raise ValueError(f'{what}: the bf16 kernel is built for T dilations {T_DILATIONS}, '
                         f'got {dt}')
    if x.dim() != 4 or x.shape[1] != Cin or (bias is not None and bias.shape != (Cout,)):
        raise ValueError(f'{what}: x {tuple(x.shape)}, w {tuple(w.shape)}')
    B, _, T, F_ = x.shape
    To, Fo = disc_conv_kernel.out_size(T, F_, KT, KF, STRIDE[1], dt, pt, pf)
    if To <= 0 or Fo <= 0:
        raise ValueError(f'{what}: empty output for x {tuple(x.shape)}')
    return forward_packed(x, pack_weight_cuda(w), bias, dilation, padding)


disc_im2col_forward.launches = 0
disc_im2col_forward_bf16.launches = 0


def forward_packed(x: torch.Tensor, wk: torch.Tensor, bias: Optional[torch.Tensor],
                   dilation: Pair, padding: Pair) -> torch.Tensor:
    """K5's launch alone (in x's dtype), from weights already packed by
    :func:`pack_weight_cuda`: what the forward entries run after their checks
    and the packing. Not counted in ``launches``."""
    B, Cin, T, F_ = x.shape
    dt, pt, pf = dilation[0], padding[0], padding[1]
    To, Fo = disc_conv_kernel.out_size(T, F_, *TAPS, STRIDE[1], dt, pt, pf)
    y = torch.empty(B, CHANNELS, To, Fo, device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load()
    entry = lib.encodec_disc_im2col_fwd_bf16 if x.dtype == torch.bfloat16 else \
        lib.encodec_disc_im2col_fwd_f32
    rc = entry(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr() if bias is not None else None,
        y.data_ptr(), B, Cin, CHANNELS, T, F_, *TAPS, dt, pt, pf, ctypes.c_void_p(stream))
    _build.check(rc, 'disc_im2col forward kernel')
    return y


class _DiscIm2col(torch.autograd.Function):
    """K5 forward; backward: K4's dx and cuDNN's weight gradient, each in the
    inputs' dtype."""

    @staticmethod
    def forward(ctx, x, w, bias, dilation, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = dilation, padding
        ctx.has_bias = bias is not None
        return disc_im2col_forward(x, w, bias, dilation, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dilation, padding = ctx.geometry
        gy = gy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = disc_conv_kernel.disc_conv_input_grad(gy, w, x.shape, STRIDE, dilation,
                                                       padding)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, gy, stride=STRIDE, padding=padding,
                                             dilation=dilation)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = gy.sum((0, 2, 3))
        return dx, dw, db, None, None


def disc_im2col(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                dilation: Pair, padding: Pair) -> torch.Tensor:
    """The trainable conv at F-stride 2: kernel K5 forward, K4 dx and cuDNN's
    dW for CUDA tensors; the same split over the plain versions on the
    CPU."""
    return _DiscIm2col.apply(x.contiguous(), w.contiguous(), bias, tuple(dilation),
                             tuple(padding))
