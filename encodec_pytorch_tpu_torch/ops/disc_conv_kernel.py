"""Discriminator conv: the CUDA kernel K4 (``csrc/disc_conv.cu``), forward and
input gradient, and their plain versions.

Port of ``encodec_pytorch_tpu/ops/pallas_conv2d_v2.py`` (``conv2d_v2``,
``conv2d_v2_dx`` and the custom VJP ``conv2d_v2_op``). Layout is torch's
NCHW with H = STFT frames (time) and W = frequency bins: ``x [B, Cin, T, F]``,
``w [Cout, Cin, KT, KF]``. The kernel takes time stride 1, no frequency
dilation, any time dilation and zero padding, and the discriminator's taps:
3×9 at frequency stride 2 (conv_1..3) and 3×3 at stride 1 (conv_4).

- :func:`disc_conv_forward` — ``F.conv2d`` of that class; kernel K4's forward
  entry on CUDA.
- :func:`disc_conv_input_grad` — the input gradient
  (``torch.nn.grad.conv2d_input``) in gather form; K4's dx entry on CUDA.
- :func:`disc_conv` — the trainable conv (a ``torch.autograd.Function`` on
  CUDA): K4 forward, K4 dx, and the weight gradient from
  ``torch.nn.grad.conv2d_weight``, as the JAX package takes dW from XLA.

K4 takes float32 or bfloat16, as the TPU kernel takes its input's dtype.
In float32 it runs on the tensor cores in 3xTF32: each operand is split into
two TF32 parts (:func:`split_tf32`, the bits of ``cvt.rna.tf32.f32``) and each
term is the sum of three TF32 products, so the result holds the f32 conv to
within 1e-5 of its largest value. :func:`pack_weight` splits the weights once
a call and lays them out in the order of the kernel's ``mma`` fragments; on
the card :func:`pack_weight_cuda` does the same in one launch. In bfloat16
(:func:`disc_conv_forward_bf16`, :func:`disc_conv_input_grad_bf16`) it is a
kernel of its own (``csrc/disc_conv_bf16.cu``): bf16 ``wgmma`` products
summed in f32, the sum rounded to bf16 and the bias added after that
rounding, in bf16 (the JAX package's dtype rule, ``ops/conv.py:263``); its
weights are the B images of :func:`pack_weight_bf16`, one per k-step of
:func:`bf16_steps`, laid out by one launch a call (:func:`pack_weight_cuda`).
The plain versions in bf16 are the f32 conv of the bf16 operands, rounded to
bf16, then the bias added in bf16: that defines the semantics exactly,
whatever a bf16 conv on the CPU does.

Each wrapper runs its plain version only for CPU tensors. For a CUDA tensor it
launches the kernel of the tensors' dtype, or raises on a dtype, shape or
stride it does not take: a bf16 call never reaches cuDNN or the f32 kernel.
``launches`` on each entry counts kernel launches (the bf16 entries have
their own). Which convs are routed here
is :func:`eligible`, a copy of the JAX package's ``v2_ok``
(``ops/conv.py:233-240``). The F-phase packing (``fpack``), the
double-buffered im2col and the 128-lane padding of the TPU kernel are not
carried over: they fit the TPU's matrix unit. The design, and what bounds the
kernel, are in the source's head comment.
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

# The JAX package's kernel packs TPU_FPACK output positions into N_MF padded
# taps; its eligibility rule (`taps_fit`) is kept so both packages route the
# same convs.
TPU_FPACK = 4
TPU_N_MF = 16

Pair = Tuple[int, int]

# (KT, KF, F-stride) of the convs the kernel is built for
KERNEL_TAPS = ((3, 9, 2), (3, 3, 1))
# the kernel's tiles (csrc/disc_conv.cu): summed channels a chunk (f32;
# bf16), output channels a block, and the mma fragments' lanes
CHUNK = 4
CHUNK_BF16 = 8
OUT_TILE = 32
LANES = 32
# the bf16 kernel's tiles (csrc/disc_conv_bf16.cu): output columns a tile of
# a one-phase correlation (two core matrices of wgmma's A operand), and a
# k-step's B image (32 output channels x 16 k, bf16)
BF16_COLS = 16
B_IMAGE_BF16 = 512
DTYPES = (torch.float32, torch.bfloat16)


def eligible(in_channels: int, out_channels: int, kernel_size: Pair, stride: Pair,
             dilation: Pair, padding: Pair) -> bool:
    """The JAX package's ``v2_ok``: T-stride 1, no F dilation, Cin and Cout
    >= 32, ``(kh-1)·dt >= ph``, and the packed taps fit."""
    kh, kw = kernel_size
    return (stride[0] == 1 and dilation[1] == 1 and in_channels >= 32
            and out_channels >= 32 and (kh - 1) * dilation[0] >= padding[0]
            and (TPU_FPACK - 1) * stride[1] + kw <= TPU_N_MF)


def _geometry(w: torch.Tensor, stride: Pair, dilation: Pair, padding: Pair):
    if stride[0] != 1 or dilation[1] != 1 or stride[1] not in (1, 2):
        raise ValueError(f'disc_conv kernel: takes T-stride 1, F-stride 1 or 2 and no F '
                         f'dilation, got stride {stride}, dilation {dilation}')
    if min(padding) < 0 or dilation[0] < 1:
        raise ValueError(f'disc_conv kernel: bad padding {padding} or dilation {dilation}')
    Cout, Cin, KT, KF = w.shape
    if (KT, KF, stride[1]) not in KERNEL_TAPS:
        raise ValueError(f'disc_conv kernel: built for (KT, KF, F-stride) in {KERNEL_TAPS}, '
                         f'got {(KT, KF, stride[1])}')
    return Cout, Cin, KT, KF, stride[1], dilation[0], padding[0], padding[1]


def _check_cuda(what: str, *tensors: Optional[torch.Tensor],
                dtype: torch.dtype = torch.float32) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError(f'{what}: tensors must be on one CUDA device (or all on the CPU)')
        if t.dtype != dtype:
            raise TypeError(f'{what}: {dtype} only (all inputs one dtype), got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{what}: inputs must be contiguous')


def out_size(T: int, F_: int, KT: int, KF: int, sf: int, dt: int, pt: int, pf: int) -> Pair:
    return T + 2 * pt - (KT - 1) * dt, (F_ + 2 * pf - KF) // sf + 1


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = cvt.rna.tf32.f32(v)`` and ``lo`` the same
    rounding of ``v - hi``, emulated on the bits: round the magnitude to 10
    mantissa bits, to nearest with ties away from zero (add half of the 13
    dropped bits, then clear them). ``hi + lo`` is within ``2**-22 |v|`` of
    ``v``. float32 in, float32 out."""
    def rna(u: torch.Tensor) -> torch.Tensor:
        bits = u.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(v)
    return hi, rna(v - hi)


def pack_weight(wc: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand, from the correlation weights
    ``wc [P, C, KT, NJ, O]`` (phase, channels summed over, taps, channels
    written): split by :func:`split_tf32` and laid out as
    ``[P, O/32, C/4, ceil(KT·NJ/2), 4, 32, 4]`` (C, O and the taps padded
    with zeros): phase, output tile, chunk of 4 summed channels, k-step (two
    taps), n-fragment, lane ``4g + q``, and the lane's B fragment ``(hi b0,
    hi b1, lo b0, lo b1)``, where b0 is summed channel q at the k-step's
    first tap, b1 at its second, both for output channel 8·fragment + g."""
    P, C, KT, NJ, O = wc.shape
    taps = KT * NJ
    steps = -(-taps // 2)
    Cp, Op = -(-C // CHUNK) * CHUNK, -(-O // OUT_TILE) * OUT_TILE
    w = F.pad(wc.reshape(P, C, taps, O), (0, Op - O, 0, 2 * steps - taps, 0, Cp - C))
    # p, chunk, q, k-step, tap of the pair, output tile, n-fragment, g
    w = w.reshape(P, Cp // CHUNK, CHUNK, steps, 2, Op // OUT_TILE, 4, 8)
    w = w.permute(0, 5, 1, 3, 6, 7, 2, 4)
    hi, lo = split_tf32(w.contiguous())
    return torch.cat([hi, lo], -1).reshape(P, Op // OUT_TILE, Cp // CHUNK, steps, 4, LANES,
                                           4).contiguous()


def bf16_staged_col(S: int, NJ: int, j: int) -> int:
    """Where the bf16 kernel stages window column ``j`` (relative to a tile's
    first input column): at F-stride 2 (a forward, one phase) the even
    columns first, then the odd ones, so that neighbouring output columns
    read neighbouring staged columns at every tap."""
    if S == 1:
        return j
    half = ((BF16_COLS - 1) * S + NJ + 1) // 2
    return j // 2 + (j % 2) * half


@functools.lru_cache(maxsize=None)
def bf16_steps(S: int, KT: int, NJ: int, P: int, phase: int):
    """The bf16 kernel's k-steps for ``phase``: its taps ``(mt, j)`` in the
    order of their staged addresses (row, then staged column), two a k-step
    (k 0-7: the chunk's 8 channels at the first tap, k 8-15 at the second;
    ``None`` pads an odd count with zero weights). Phase 1 of a two-phase
    input gradient (taps 3x5 of a 3x9 conv at F-stride 2) has no tap ``j =
    0``: its weights are zero there."""
    taps = sorted(((mt, j) for mt in range(KT) for j in range(NJ)
                   if not (P == 2 and phase == 1 and j == 0)),
                  key=lambda t: (t[0], bf16_staged_col(S, NJ, t[1])))
    taps.append(None)
    return tuple((taps[2 * i], taps[2 * i + 1]) for i in range(len(taps) // 2))


def pack_weight_bf16(wc: torch.Tensor, S: int) -> torch.Tensor:
    """The bf16 kernel's weight operand, from the correlation weights ``wc [P,
    C, KT, NJ, O]`` (bf16) of a correlation at F-stride ``S``: ``[ceil(O/32),
    ceil(C/8), steps, 512]``, per output tile of 32 channels and chunk of 8
    summed channels the B images of :func:`bf16_steps`' k-steps, phase 0's,
    then phase 1's. A B image is ``wgmma``'s K-major operand without swizzle
    (core matrices of 8 channels x 8 k): element ``(n, k)`` sits at ``(n //
    8)·128 + (k // 8)·64 + (n % 8)·8 + k % 8`` and is ``wc[phase, 8·chunk +
    k % 8, mt, j, 32·tile + n]`` for the k-step's tap ``(mt, j)`` number ``k
    // 8``; zero past C, O and at a padding tap. No rounding: the values are
    moved."""
    P, C, KT, NJ, O = wc.shape
    Cp, Op = -(-C // CHUNK_BF16) * CHUNK_BF16, -(-O // OUT_TILE) * OUT_TILE
    wc = F.pad(wc, (0, Op - O, 0, 0, 0, 0, 0, Cp - C))
    zero = wc.new_zeros(Cp, Op)
    images = []
    for r in range(P):
        for pair in bf16_steps(S, KT, NJ, P, r):
            # [Cp, Op] at each of the two taps -> [chunk, 2, c, tile, n]
            halves = [zero if t is None else wc[r, :, t[0], t[1], :] for t in pair]
            images.append(torch.stack(halves, 0).reshape(2, Cp // CHUNK_BF16, CHUNK_BF16,
                                                         Op // OUT_TILE, OUT_TILE))
    w = torch.stack(images, 0)              # step, half, chunk, c, tile, n
    w = w.reshape(len(images), 2, Cp // CHUNK_BF16, CHUNK_BF16, Op // OUT_TILE, 4, 8)
    # tile, chunk, step, n // 8, half, n % 8, c
    return w.permute(4, 2, 0, 5, 1, 6, 3).reshape(
        Op // OUT_TILE, Cp // CHUNK_BF16, len(images), B_IMAGE_BF16).contiguous()


def pack_weight_cuda(w: torch.Tensor, sf: int, dx: bool) -> torch.Tensor:
    """:func:`pack_weight` (float32 ``w``) or :func:`pack_weight_bf16`
    (bfloat16 ``w``) of the forward's (``dx`` False: ``w.permute(1, 2, 3,
    0)[None]`` at F-stride ``sf``) or the input gradient's
    (``pack_dx_weight(w, sf)`` at F-stride 1) correlation weights, in one
    launch on the card, from ``w [Cout, Cin, KT, KF]`` (contiguous, on CUDA).
    The same bits as the plain version."""
    Cout, Cin, KT, KF = w.shape
    C, O, NJ = (Cout, Cin, -(-KF // sf)) if dx else (Cin, Cout, KF)
    lead = (sf if dx else 1, -(-O // OUT_TILE))
    steps = -(-KT * NJ // 2)
    lib = _build.load()
    if w.dtype == torch.bfloat16:
        S, P = (1, sf) if dx else (sf, 1)
        steps = sum(len(bf16_steps(S, KT, NJ, P, r)) for r in range(P))
        out = torch.empty(lead[1], -(-C // CHUNK_BF16), steps, B_IMAGE_BF16, device=w.device,
                          dtype=torch.bfloat16)
        entry = lib.encodec_disc_conv_pack_bf16
    else:
        out = torch.empty(*lead, -(-C // CHUNK), steps, 4, LANES, 4, device=w.device,
                          dtype=torch.float32)
        entry = lib.encodec_disc_conv_pack_f32
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = entry(w.data_ptr(), out.data_ptr(), Cout, Cin, KT, KF, sf, int(dx), w.device.index,
               ctypes.c_void_p(stream))
    _build.check(rc, 'disc_conv weight-packing kernel')
    return out


def disc_conv_forward_reference(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                                stride: Pair, dilation: Pair, padding: Pair) -> torch.Tensor:
    """Plain forward: ``F.conv2d``; in bf16, the f32 conv of the bf16
    operands rounded to bf16, then the bias added in bf16."""
    if x.dtype == torch.float32:
        return F.conv2d(x, w, bias, stride=stride, padding=padding, dilation=dilation)
    y = F.conv2d(x.float(), w.float(), None, stride=stride, padding=padding,
                 dilation=dilation).to(x.dtype)
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def disc_conv_input_grad_reference(g: torch.Tensor, w: torch.Tensor, x_shape: Sequence[int],
                                   stride: Pair, dilation: Pair, padding: Pair) -> torch.Tensor:
    """Plain input gradient: ``torch.nn.grad.conv2d_input``; in bf16, that
    of the bf16 operands in f32, rounded to bf16."""
    return torch.nn.grad.conv2d_input(tuple(x_shape), w.float(), g.float(), stride=stride,
                                      padding=padding, dilation=dilation).to(g.dtype)


def _forward_checked(what: str, x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                     stride: Pair, dilation: Pair, padding: Pair,
                     dtype: torch.dtype) -> torch.Tensor:
    _check_cuda(what, x, w, bias, dtype=dtype)
    Cout, Cin, KT, KF, sf, dt, pt, pf = _geometry(w, stride, dilation, padding)
    if x.dim() != 4 or x.shape[1] != Cin or (bias is not None and bias.shape != (Cout,)):
        raise ValueError(f'{what}: x {tuple(x.shape)}, w {tuple(w.shape)}')
    B, _, T, F_ = x.shape
    To, Fo = out_size(T, F_, KT, KF, sf, dt, pt, pf)
    if To <= 0 or Fo <= 0:
        raise ValueError(f'{what}: empty output for x {tuple(x.shape)}')
    return forward_packed(x, pack_weight_cuda(w, sf, dx=False), bias, w.shape, stride, dilation,
                          padding)


def disc_conv_forward(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                      stride: Pair, dilation: Pair, padding: Pair) -> torch.Tensor:
    """``F.conv2d(x, w, bias, stride, padding, dilation)``; kernel K4 on CUDA
    (bfloat16 inputs: :func:`disc_conv_forward_bf16`)."""
    if x.device.type == 'cpu' and w.device.type == 'cpu':
        return disc_conv_forward_reference(x, w, bias, stride, dilation, padding)
    if x.dtype == torch.bfloat16:
        return disc_conv_forward_bf16(x, w, bias, stride, dilation, padding)
    y = _forward_checked('disc_conv_forward', x, w, bias, stride, dilation, padding,
                         torch.float32)
    disc_conv_forward.launches += 1
    return y


def disc_conv_forward_bf16(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                           stride: Pair, dilation: Pair, padding: Pair) -> torch.Tensor:
    """The conv in bf16 (x, w and bias bf16): K4's bf16 kernel on CUDA, the
    plain version on the CPU."""
    if x.device.type == 'cpu' and w.device.type == 'cpu':
        return disc_conv_forward_reference(x, w, bias, stride, dilation, padding)
    y = _forward_checked('disc_conv_forward_bf16', x, w, bias, stride, dilation, padding,
                         torch.bfloat16)
    disc_conv_forward_bf16.launches += 1
    return y


def pack_dx_weight(w: torch.Tensor, sf: int) -> torch.Tensor:
    """``[sf, Cout, KT, NJ, Cin]`` with ``NJ = ceil(KF / sf)`` and
    ``[r, co, m, j, ci] = w[co, ci, KT-1-m, r + sf·(NJ-1-j)]`` (0 past KF):
    for output phase r, the taps of dx as a stride-1 correlation of the
    cotangent, reversed along T and F."""
    Cout, Cin, KT, KF = w.shape
    NJ = -(-KF // sf)
    wp = F.pad(w.flip(2), (0, NJ * sf - KF)).reshape(Cout, Cin, KT, NJ, sf).flip(3)
    return wp.permute(4, 0, 2, 3, 1).contiguous()


def _input_grad_checked(what: str, g: torch.Tensor, w: torch.Tensor, x_shape: Sequence[int],
                        stride: Pair, dilation: Pair, padding: Pair,
                        dtype: torch.dtype) -> torch.Tensor:
    _check_cuda(what, g, w, dtype=dtype)
    Cout, Cin, KT, KF, sf, dt, pt, pf = _geometry(w, stride, dilation, padding)
    B, cin, T, F_ = x_shape
    if g.dim() != 4 or cin != Cin or tuple(g.shape) != (B, Cout, *out_size(
            T, F_, KT, KF, sf, dt, pt, pf)):
        raise ValueError(f'{what}: g {tuple(g.shape)}, w {tuple(w.shape)}, x {tuple(x_shape)}')
    return input_grad_packed(g, pack_weight_cuda(w, sf, dx=True), w.shape, x_shape, stride,
                             dilation, padding)


def disc_conv_input_grad(g: torch.Tensor, w: torch.Tensor, x_shape: Sequence[int],
                         stride: Pair, dilation: Pair, padding: Pair) -> torch.Tensor:
    """Gradient with respect to ``x`` of the conv, given the output's
    cotangent ``g``; kernel K4's dx entry on CUDA (bfloat16 inputs:
    :func:`disc_conv_input_grad_bf16`)."""
    if g.device.type == 'cpu' and w.device.type == 'cpu':
        return disc_conv_input_grad_reference(g, w, x_shape, stride, dilation, padding)
    if g.dtype == torch.bfloat16:
        return disc_conv_input_grad_bf16(g, w, x_shape, stride, dilation, padding)
    dx = _input_grad_checked('disc_conv_input_grad', g, w, x_shape, stride, dilation, padding,
                             torch.float32)
    disc_conv_input_grad.launches += 1
    return dx


def disc_conv_input_grad_bf16(g: torch.Tensor, w: torch.Tensor, x_shape: Sequence[int],
                              stride: Pair, dilation: Pair, padding: Pair) -> torch.Tensor:
    """The input gradient in bf16 (g and w bf16): K4's bf16 dx kernel on
    CUDA, the plain version on the CPU."""
    if g.device.type == 'cpu' and w.device.type == 'cpu':
        return disc_conv_input_grad_reference(g, w, x_shape, stride, dilation, padding)
    dx = _input_grad_checked('disc_conv_input_grad_bf16', g, w, x_shape, stride, dilation,
                             padding, torch.bfloat16)
    disc_conv_input_grad_bf16.launches += 1
    return dx


disc_conv_forward.launches = 0
disc_conv_input_grad.launches = 0
disc_conv_forward_bf16.launches = 0
disc_conv_input_grad_bf16.launches = 0


def forward_packed(x: torch.Tensor, wk: torch.Tensor, bias: Optional[torch.Tensor],
                   w_shape: Sequence[int], stride: Pair, dilation: Pair,
                   padding: Pair) -> torch.Tensor:
    """K4's forward launch alone (in x's dtype), from weights already packed
    by :func:`pack_weight_cuda`: what :func:`disc_conv_forward` and
    :func:`disc_conv_forward_bf16` run after their checks and the packing. Not
    counted in ``launches``."""
    Cout, Cin, KT, KF = w_shape
    sf, dt, (pt, pf) = stride[1], dilation[0], padding
    B, _, T, F_ = x.shape
    y = torch.empty(B, Cout, *out_size(T, F_, KT, KF, sf, dt, pt, pf), device=x.device,
                    dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load()
    entry = lib.encodec_disc_conv_fwd_bf16 if x.dtype == torch.bfloat16 else \
        lib.encodec_disc_conv_fwd_f32
    rc = entry(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr() if bias is not None else None,
        y.data_ptr(), B, Cin, Cout, T, F_, KT, KF, sf, dt, pt, pf, x.device.index,
        ctypes.c_void_p(stream))
    _build.check(rc, 'disc_conv forward kernel')
    return y


def input_grad_packed(g: torch.Tensor, wk: torch.Tensor, w_shape: Sequence[int],
                      x_shape: Sequence[int], stride: Pair, dilation: Pair,
                      padding: Pair) -> torch.Tensor:
    """K4's input-gradient launch alone (in g's dtype), from weights already
    packed by :func:`pack_weight_cuda` (``dx`` True): what the input-gradient
    entries run after their checks and the packing. Not counted in
    ``launches``."""
    Cout, Cin, KT, KF = w_shape
    sf, dt, (pt, pf) = stride[1], dilation[0], padding
    B, _, T, F_ = x_shape
    dx = torch.empty(B, Cin, T, F_, device=g.device, dtype=g.dtype)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    lib = _build.load()
    entry = lib.encodec_disc_conv_dx_bf16 if g.dtype == torch.bfloat16 else \
        lib.encodec_disc_conv_dx_f32
    rc = entry(
        g.data_ptr(), wk.data_ptr(), dx.data_ptr(), B, Cin, Cout, T, F_, KT, KF, sf, dt, pt,
        pf, g.device.index, ctypes.c_void_p(stream))
    _build.check(rc, 'disc_conv input-gradient kernel')
    return dx


class _DiscConv(torch.autograd.Function):
    """K4 forward; backward: K4 dx and cuDNN's weight gradient, each in the
    inputs' dtype."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, dilation, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = stride, dilation, padding
        ctx.has_bias = bias is not None
        return disc_conv_forward(x, w, bias, stride, dilation, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, dilation, padding = ctx.geometry
        gy = gy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = disc_conv_input_grad(gy, w, x.shape, stride, dilation, padding)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, gy, stride=stride, padding=padding,
                                             dilation=dilation)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = gy.sum((0, 2, 3))
        return dx, dw, db, None, None, None


def disc_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], stride: Pair,
              dilation: Pair, padding: Pair) -> torch.Tensor:
    """The trainable conv: the plain forward (and its autograd) for CPU
    tensors, kernel K4 forward and dx for CUDA tensors, in float32 or
    bfloat16."""
    if x.device.type == 'cpu' and w.device.type == 'cpu':
        return disc_conv_forward_reference(x, w, bias, stride, dilation, padding)
    return _DiscConv.apply(x.contiguous(), w.contiguous(), bias, tuple(stride),
                           tuple(dilation), tuple(padding))
