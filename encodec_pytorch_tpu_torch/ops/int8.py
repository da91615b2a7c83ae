"""Symmetric int8 weight-only quantization, one scale a channel.

The rule of ``encodec_pytorch_tpu/prepare.py`` ``quantize_weights`` and
``dequantize_weights``: ``scale = where(amax > 0, amax, 1) / 127`` and
``q = clip(round(w / scale), -127, 127)`` (rounding half to even), in f32.
The JAX package reduces over every axis but the last of its layouts (conv
``[k, in, out]``, transposed conv ``[k, out, in]``, LSTM ``[in, 4H]``); in
torch's layouts (``[out, in, k]``, ``[in, out, k]``, ``[4H, in]``) that
trailing axis is dim 0, so here the scale is one a row of dim 0.
"""

from typing import Tuple

import torch


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q8, scale)``: ``q8`` int8 of ``w``'s shape, ``scale`` f32 ``[w.shape[0]]``."""
    w = w.detach().float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q8 = torch.clamp(torch.round(w / _rows(scale, w.dim())), -127, 127).to(torch.int8)
    return q8, scale


def dequantize_int8(q8: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q8 · scale`` in ``dtype`` (both operands cast to it first, as the JAX
    package's ``dequantize_weights`` casts them)."""
    return q8.to(dtype) * _rows(scale.to(dtype), q8.dim())


def _rows(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape(-1, *([1] * (ndim - 1)))
