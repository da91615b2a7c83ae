"""Fused SEANet residual block: the CUDA kernel K3 (``csrc/resblock.cu``) and
its plain version.

Port of ``encodec_pytorch_tpu/ops/pallas_resblock.py`` (``resblock_pallas``),
in torch's NCT layout: ``x [B, C, T]`` f32 and the materialised weights in
torch's conv layout, ``k1 [H, C, 3]``, ``k2 [C, H]`` and ``ks [C, C]`` (a
trailing tap axis of 1 is accepted), with their biases. Both functions compute
``ks·x + bs + k2·ELU(k1 ⊛ ELU(pad(x)) + b1) + b2``, the block of
``models/seanet.py`` ``SEANetResnetBlock``: the k3 conv dilated by
``dilation``, padded causally (``2d`` on the left) or ``d`` on each side, in
``pad_mode`` (``reflect``, with ``ops/pad.py``'s short-input guard, or zero).

:func:`resblock_int8` takes the int8 twin's weights (``prepare.py``): int8
``k1``, ``k2``, ``ks`` in the same layouts, each with an f32 scale a row
(``s1 [H]``, ``s2 [C]``, ``ss [C]``). The kernel reads the int8 bytes (by
8-bit TMA tensor copies where every row is a multiple of 16 bytes) and
dequantizes each weight, ``q · scale[row]`` in f32, before its product, so its
output is the f32 kernel's on the dequantized weights, bit for bit; its plain
version :func:`resblock_int8_reference` dequantizes, then runs
:func:`resblock_reference`.

``left [B, C, 2d]``, for a causal block only, is the streaming halo: the
previous chunk's last ``2d`` inputs of the k3 conv, already activated (the
carry of ``encodec_pytorch_tpu/streaming.py`` ``_stream_conv``, transposed to
NCT). It replaces the left padding. With ``return_carry`` the functions also
return the next chunk's halo.

:func:`resblock` launches the kernel for CUDA tensors (one launch a block, the
padding and both activations included, each time tile split over a
thread-block cluster by output rows) and runs :func:`resblock_reference`
only for CPU tensors. The TPU kernel's 2048-sample tiles, NTC transposes and
``Tpad`` rounding were VMEM and lane rules and are not carried over.
"""

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build
from .int8 import dequantize_int8
from .pad import pad1d

PAD_MODES = ('reflect', 'zero', 'constant')
# the widest block K3 takes (C and 2H): every CTA of a cluster holds the
# tile's whole input and y1, which past C 512 outgrow its shared memory
MAX_CHANNELS = 512

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _check_halo(x: torch.Tensor, left: Optional[torch.Tensor], dilation: int, causal: bool,
                return_carry: bool) -> None:
    B, C, T = x.shape
    if left is not None:
        if not causal:
            raise ValueError('resblock: a streaming halo (left) needs a causal block')
        if tuple(left.shape) != (B, C, 2 * dilation):
            raise ValueError(f'resblock: left {tuple(left.shape)} is not '
                             f'[B, C, 2d] = {(B, C, 2 * dilation)}')
    elif return_carry and T < 2 * dilation:
        raise ValueError(f'resblock: a chunk of {T} samples without a halo cannot give '
                         f'the {2 * dilation} of the next one')


def resblock_reference(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
                       k2: torch.Tensor, b2: torch.Tensor, ks: torch.Tensor,
                       bs: torch.Tensor, *, dilation: int, causal: bool,
                       pad_mode: str = 'reflect', left: Optional[torch.Tensor] = None,
                       return_carry: bool = False) -> Out:
    """Plain PyTorch block: ELU, ``pad1d``, three ``F.conv1d`` and the add."""
    _check_halo(x, left, dilation, causal, return_carry)
    d = dilation
    a = F.elu(x)
    if left is not None:
        ap = torch.cat([left, a], dim=-1)
    elif causal:
        ap = pad1d(a, (2 * d, 0), mode=pad_mode)
    else:
        ap = pad1d(a, (d, d), mode=pad_mode)
    C = x.shape[1]
    y = F.elu(F.conv1d(ap, k1, b1, dilation=d))
    y = F.conv1d(y, k2.reshape(C, -1, 1), b2)
    out = F.conv1d(x, ks.reshape(C, C, 1), bs) + y
    if not return_carry:
        return out
    tail = a if left is None else torch.cat([left, a], dim=-1)
    return out, tail[..., tail.shape[-1] - 2 * d:]


def resblock_int8_reference(x: torch.Tensor, k1: torch.Tensor, s1: torch.Tensor,
                            b1: torch.Tensor, k2: torch.Tensor, s2: torch.Tensor,
                            b2: torch.Tensor, ks: torch.Tensor, ss: torch.Tensor,
                            bs: torch.Tensor, **kwargs) -> Out:
    """Plain int8-weight block: the weights dequantized in f32, then
    :func:`resblock_reference`."""
    return resblock_reference(x, dequantize_int8(k1, s1), b1, dequantize_int8(k2, s2), b2,
                              dequantize_int8(ks, ss), bs, **kwargs)


def _refuse(x, k1, b1, k2, b2, ks, bs, tensors, dilation: int, pad_mode: str,
            scales=()) -> None:
    """Raise the reason a CUDA call of :func:`resblock` (or, with ``scales``,
    :func:`resblock_int8`) is refused."""
    if x.device.type != 'cuda' or any(t.device != x.device for t in tensors):
        raise ValueError(f'resblock: tensors on {sorted({str(t.device) for t in tensors})}; '
                         'all must be on one CUDA device (or all on the CPU)')
    wtype = torch.int8 if scales else torch.float32
    weights = (k1, k2, ks)
    if any(t.dtype != (wtype if any(t is w for w in weights) else torch.float32)
           for t in tensors):
        raise TypeError(f'resblock: weights {wtype} and everything else float32, got '
                        f'{[str(t.dtype) for t in tensors]}')
    for s, w in zip(scales, weights):
        if s.shape != w.shape[:1]:
            raise ValueError(f'resblock: a weight scale {tuple(s.shape)} is not '
                             f'[{w.shape[0]}], one a row')
    if pad_mode not in PAD_MODES:
        raise ValueError(f'resblock: unsupported pad mode {pad_mode!r}')
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f'resblock: x {tuple(x.shape)} is not a non-empty [B, C, T]')
    if dilation < 1:
        raise ValueError(f'resblock: dilation {dilation} < 1')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('resblock: inputs must be contiguous')
    if x.shape[1] > MAX_CHANNELS or 2 * k1.shape[0] > MAX_CHANNELS:
        raise ValueError(f'resblock: C {x.shape[1]} and 2H {2 * k1.shape[0]} must be at most '
                         f'{MAX_CHANNELS}')
    raise ValueError(f'resblock: weights k1 {tuple(k1.shape)}, b1 {tuple(b1.shape)}, '
                     f'k2 {tuple(k2.shape)}, b2 {tuple(b2.shape)}, ks {tuple(ks.shape)}, '
                     f'bs {tuple(bs.shape)} do not make [H, C, 3], [H], [C, H], [C], '
                     f'[C, C], [C] at C = {x.shape[1]}')


def launch_config(C: int, H: int) -> dict:
    """The launch K3 makes for a block of ``C`` channels and ``H`` hidden: the
    cluster size (CTAs that split the output rows) and the columns of a tile
    (both 0 past :data:`MAX_CHANNELS`)."""
    out = [ctypes.c_int() for _ in range(2)]
    _build.load().encodec_resblock_config(C, H, *(ctypes.byref(v) for v in out))
    return dict(zip(('cluster', 'tile'), (v.value for v in out)))


def _launch(x, k1, b1, k2, b2, ks, bs, scales, *, dilation: int, causal: bool, pad_mode: str,
            left: Optional[torch.Tensor], return_carry: bool) -> Out:
    """Check a CUDA call and launch K3: its f32 entry, or with ``scales``
    (``s1``, ``s2``, ``ss``) its int8-weight entry."""
    tensors = (x, k1, b1, k2, b2, ks, bs, *scales) + (() if left is None else (left,))
    # one cheap test of everything the kernel needs; _refuse says what failed
    device = x.get_device()
    shape = x.shape
    C, H = (shape[1] if len(shape) == 3 else -1), k1.shape[0]
    wtype = torch.int8 if scales else torch.float32
    if not (device >= 0 and len(shape) == 3 and shape[0] > 0 and shape[2] > 0
            and dilation >= 1 and pad_mode in PAD_MODES
            and all(t.get_device() == device and t.is_contiguous() for t in tensors)
            and k1.dtype is wtype and k2.dtype is wtype and ks.dtype is wtype
            and all(t.dtype is torch.float32 for t in (x, b1, b2, bs, *scales))
            and (left is None or left.dtype is torch.float32)
            and k1.shape == (H, C, 3) and k2.shape[:2] == (C, H) and k2.numel() == C * H
            and ks.shape[:2] == (C, C) and ks.numel() == C * C
            and b1.shape == (H,) and b2.shape == (C,) and bs.shape == (C,)
            and (not scales or tuple(t.shape for t in scales) == ((H,), (C,), (C,)))
            and C <= MAX_CHANNELS and 2 * H <= MAX_CHANNELS):
        _refuse(x, k1, b1, k2, b2, ks, bs, tensors, dilation, pad_mode, scales)
    _check_halo(x, left, dilation, causal, return_carry)
    B, _, T = shape
    out = torch.empty_like(x)
    carry = (torch.empty(B, C, 2 * dilation, device=x.device, dtype=torch.float32)
             if return_carry else None)
    lib = _build.load()
    ptrs = [x.data_ptr(), None if left is None else left.data_ptr()]
    if scales:
        s1, s2, ss = scales
        ptrs += [k1.data_ptr(), s1.data_ptr(), b1.data_ptr(), k2.data_ptr(), s2.data_ptr(),
                 b2.data_ptr(), ks.data_ptr(), ss.data_ptr(), bs.data_ptr()]
        entry, what = lib.encodec_resblock_i8w, 'resblock int8-weight kernel'
    else:
        ptrs += [k1.data_ptr(), b1.data_ptr(), k2.data_ptr(), b2.data_ptr(), ks.data_ptr(),
                 bs.data_ptr()]
        entry, what = lib.encodec_resblock_f32, 'resblock kernel'
    rc = entry(*ptrs, out.data_ptr(), None if carry is None else carry.data_ptr(), B, C, H, T,
               dilation, int(causal), int(pad_mode == 'reflect'), device,
               ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _build.check(rc, what)
    return (out, carry) if return_carry else out


def resblock(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
             b2: torch.Tensor, ks: torch.Tensor, bs: torch.Tensor, *, dilation: int,
             causal: bool, pad_mode: str = 'reflect', left: Optional[torch.Tensor] = None,
             return_carry: bool = False) -> Out:
    """The block's output ``[B, C, T]`` (and, with ``return_carry``, the next
    halo ``[B, C, 2d]``); kernel K3 on CUDA."""
    kw = dict(dilation=dilation, causal=causal, pad_mode=pad_mode, left=left,
              return_carry=return_carry)
    if x.is_cpu and all(t.is_cpu for t in (k1, b1, k2, b2, ks, bs)) \
            and (left is None or left.is_cpu):
        return resblock_reference(x, k1, b1, k2, b2, ks, bs, **kw)
    out = _launch(x, k1, b1, k2, b2, ks, bs, (), **kw)
    resblock.launches += 1
    return out


resblock.launches = 0


def resblock_int8(x: torch.Tensor, k1: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                  k2: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor, ks: torch.Tensor,
                  ss: torch.Tensor, bs: torch.Tensor, *, dilation: int, causal: bool,
                  pad_mode: str = 'reflect', left: Optional[torch.Tensor] = None,
                  return_carry: bool = False) -> Out:
    """:func:`resblock` on int8 weights with their row scales; K3's
    int8-weight entry on CUDA."""
    kw = dict(dilation=dilation, causal=causal, pad_mode=pad_mode, left=left,
              return_carry=return_carry)
    if x.is_cpu and all(t.is_cpu for t in (k1, s1, b1, k2, s2, b2, ks, ss, bs)) \
            and (left is None or left.is_cpu):
        return resblock_int8_reference(x, k1, s1, b1, k2, s2, b2, ks, ss, bs, **kw)
    out = _launch(x, k1, b1, k2, b2, ks, bs, (s1, s2, ss), **kw)
    resblock_int8.launches += 1
    return out


resblock_int8.launches = 0
