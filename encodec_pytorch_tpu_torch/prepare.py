"""Serving preparation: weight-norm folding and int8 weight-only weights.

Port of ``encodec_pytorch_tpu/prepare.py``. The port's model holds its
weights, so each transform returns a twin of the model:

- :func:`fold_weight_norm`: training keeps each conv weight as ``(v, g)`` and
  computes ``g · v / ‖v‖`` in every call (``ops/conv.py``); the fold computes
  it once into a ``norm='none'`` twin. The twin evaluates the same torch
  expression the raw model evaluates per call, so its weights, codes, decodes
  and ``.ecdc`` bytes are bit-identical to the raw model's; it only skips the
  recomputation. Its resblocks are plain convs, which kernel K3 takes as it
  takes weight-normed ones.
- :func:`quantize_weights`: the int8 twin of a folded model. Every conv,
  transposed conv and 1×1 weight and every LSTM matrix becomes int8 with an
  f32 scale a channel (``ops/int8.py``: the JAX rule, on the JAX layouts'
  trailing axis, which is dim 0 of torch's); biases, the LSTM's ``bias_hh``
  and the quantizer stay f32. The twin holds only the int8 weights: each call
  dequantizes, in f32 unless :func:`quantized_call` asks for the model's
  compute dtype, as the JAX package dequantizes inside its programs. On CUDA
  the two kernels that hold weights read the int8 bytes themselves and
  dequantize before their products: K2 (``W_hh``, resident in registers) and
  K3 (its three weights, streamed by TMA). The plain convs, the transposed
  convs and the LSTM's input projection run on the weights dequantized for
  that call, as the JAX package computes those outside any Pallas kernel.
"""

import contextlib
import copy

import torch
from torch import nn

from .models.model import EncodecModel
from .models.seanet import SEANetResnetBlock
from .ops.conv import _ConvWeight
from .ops.int8 import dequantize_int8
from .ops.lstm import _LSTMWeights

WEIGHTS = ('fold', 'int8')


def _conv_norms(model: nn.Module) -> set:
    return {m.norm for m in model.modules() if isinstance(m, _ConvWeight)}


def _clear_fused(model: nn.Module) -> None:
    for block in model.modules():
        if isinstance(block, SEANetResnetBlock):
            block._fused = None          # K3's weights, cached from the old tensors


def fold_weight_norm(model: EncodecModel) -> EncodecModel:
    """A copy of ``model`` with every weight-normed conv's ``(weight_v,
    weight_g)`` replaced by the plain ``weight`` they give. The name (it
    rides in the ``.ecdc`` header), the bandwidth and the quantizer are kept,
    on the model's device.

    Raises ``ValueError`` unless the model is a ``weight_norm`` one: the
    ``time_group_norm`` family normalizes by the data and cannot fold."""
    norms = _conv_norms(model)
    if norms != {'weight_norm'}:
        raise ValueError(f"fold_weight_norm requires a weight_norm model, got norms "
                         f"{sorted(norms)}")
    folded = copy.deepcopy(model)
    with torch.no_grad():
        for conv in folded.modules():
            if isinstance(conv, _ConvWeight):
                weight = nn.Parameter(conv.kernel())
                del conv.weight_g, conv.weight_v
                conv.weight = weight
                conv.norm = 'none'
    _clear_fused(folded)
    return folded


def _holders(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, (_ConvWeight, _LSTMWeights))]


def quantize_weights(model: EncodecModel) -> EncodecModel:
    """The int8 twin of a folded model (:func:`fold_weight_norm`): a copy
    whose conv and LSTM weight matrices are int8 buffers (``weight_q8``,
    ``weight_ih_l{k}_q8``, ...) beside f32 scales (``weight_scale``, ...),
    bit-equal to the JAX package's ``quantize_weights`` of the same folded
    weights. The name, the bandwidth, the quantizer and the device are kept.

    Raises ``ValueError`` unless every conv is plain: fold a ``weight_norm``
    model first; a ``time_group_norm`` model is refused, as the fold refuses
    it."""
    norms = _conv_norms(model)
    if norms != {'none'} or any(m.int8 for m in _holders(model)):
        raise ValueError(f"quantize_weights requires a folded float model (every conv "
                         f"'none'), got norms {sorted(norms)}")
    twin = copy.deepcopy(model)
    for holder in _holders(twin):
        holder.quantize_int8()
    _clear_fused(twin)
    return twin


def dequantize_weights(model: EncodecModel, dtype: torch.dtype = torch.float32
                       ) -> EncodecModel:
    """The folded float twin of an int8 twin: each weight ``q8 · scale``
    computed in ``dtype`` (the JAX package's ``dequantize_weights``), held as
    an f32 parameter (exactly, for bf16). Run through the f32 kernels it gives
    the int8 twin's codes and output bit for bit."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for holder in _holders(out):
            if not holder.int8:
                continue
            names = ([f'weight_{m}_l{k}' for k in range(holder.num_layers) for m in ('ih', 'hh')]
                     if isinstance(holder, _LSTMWeights) else ['weight'])
            for name in names:
                q8, scale = holder._buffers.pop(f'{name}_q8'), holder._buffers.pop(f'{name}_scale')
                setattr(holder, name, nn.Parameter(dequantize_int8(q8, scale, dtype).float()))
            holder.int8 = False
    _clear_fused(out)
    return out


def param_bytes(module: nn.Module) -> int:
    """Bytes of the tensors in ``module``'s state dict. For an
    ``EncodecModel``, those of its encoder and decoder: the JAX package's
    ``params`` (the quantizer's codebooks are its ``quantizer`` collection,
    never quantized)."""
    if isinstance(module, EncodecModel):
        return param_bytes(module.encoder) + param_bytes(module.decoder)
    return sum(t.numel() * t.element_size() for t in module.state_dict().values())


def prepare_for_inference(model: EncodecModel, weights: str = 'fold') -> EncodecModel:
    """One-call serving prep. ``weights``: ``'fold'`` folds weight norm (the
    same bits); ``'int8'`` folds, then quantizes (:func:`quantize_weights`)."""
    if weights not in WEIGHTS:
        raise ValueError(f"unknown weights mode '{weights}' (one of {WEIGHTS})")
    folded = fold_weight_norm(model)
    return folded if weights == 'fold' else quantize_weights(folded)


@contextlib.contextmanager
def dequantizing_in(model: nn.Module, dtype: torch.dtype):
    """Within the block, the int8 weights of ``model`` dequantize in
    ``dtype`` (f32 otherwise)."""
    holders = [m for m in _holders(model) if m.int8]
    saved = [m.dequant_dtype for m in holders]
    for m in holders:
        m.dequant_dtype = dtype
    try:
        yield model
    finally:
        for m, d in zip(holders, saved):
            m.dequant_dtype = d


def quantized_call(model: EncodecModel, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The eval forward (encode, quantize, decode; ``model(x)``) of an int8
    twin with its weights dequantized in ``dtype`` (the model's compute dtype
    by default), as the JAX ``quantized_call`` does. The JAX package caches a
    compiled program per (dtype, bandwidth); eager PyTorch has nothing to
    cache, and the bandwidth is read at each call. In f32 the blocks and the
    LSTM take the int8 entries of K3 and K2; in bf16 the blocks are their
    conv sequences and K2 gets the f32 up-cast of the bf16-dequantized
    ``W_hh`` through its f32 entry (the JAX package's arithmetic)."""
    dtype = dtype or model.encoder.dtype
    with torch.no_grad(), dequantizing_in(model, dtype):
        return model(x)
