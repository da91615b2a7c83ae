"""Streaming (chunked) inference with carried state.

Port of ``encodec_pytorch_tpu/streaming.py`` in torch's ``[B, C, T]`` layout.
Chunk-by-chunk causal encode and decode whose concatenated output equals the
offline model's on the same samples (to f32 roundoff; the RVQ codes exactly).

How each layer streams (the math of ``ops/conv.py`` and ``ops/lstm.py``):

- causal ``SConv1d`` (kernel K, stride s, dilation d): offline left-pads
  ``pt = (K-1)·d - (s-1)`` and the last window ends exactly at ``T + pt``
  when ``s | T``, so a chunk needs only the previous ``pt`` input samples as
  carry. The first chunk reproduces offline's left padding (reflect by
  default) instead of a zero carry.
- ``SEANetResnetBlock``: for a float32 block of a weight-acting norm, one
  call of :func:`..ops.resblock_kernel.resblock` (kernel K3 on CUDA; its
  int8-weight entry ``resblock_int8`` for the int8 twin of ``prepare.py``)
  whose ``left`` halo is the k3 conv's carry, its last ``2d`` activated
  inputs; otherwise (bf16) the block's conv sequence with that same carry.
  The first chunk pads as offline does.
- ``SLSTM``: carry = per-layer (h, c), through kernel K2 with a carried state
  on CUDA (:func:`..ops.lstm_kernel.lstm_recurrence`, or for the int8 twin
  ``lstm_recurrence_int8`` on the int8 ``W_hh``).

An int8 twin (``prepare.quantize_weights``) streams with its weights
dequantized in f32 each call (the JAX package's ``dequantize_weights`` inside
its chunk programs); its convs then follow the dtype rule below.
- causal ``SConvTranspose1d`` (``trim_right_ratio == 1``): the raw (untrimmed)
  transposed conv of a chunk is ``n·s + pt`` long (``pt = K - s``); the final
  ``pt`` samples are partial sums that overlap the next chunk's head. They are
  carried (bias excluded) and overlap-added; offline's right trim is never
  emitting the final carry.

Dtype (the JAX package's rule, ``encodec_pytorch_tpu/streaming.py``): a
model built in bfloat16 streams in bfloat16. Every conv casts the chunk and
its weight to the model's dtype and follows the offline conv's arithmetic
(``ops.conv._biased``: in bf16 the f32 sum of the bf16 operands rounded to
bf16, then the bias added in bf16); the transposed conv carries its partial
sums in f32 and rounds once they are complete; the LSTM computes in f32 as
offline; the encoder's latent and the decoder's waveform come out f32. The
carries are f32 whatever the dtype, as the JAX package stores them.

State: a dict keyed as the JAX package's (``layer_{i}``, and ``block_1``/
``block_3`` inside a block), every tensor with the batch on axis 0: conv
carries ``[B, C_in, pt]`` (the JAX ``[B, pt, C_in]`` transposed), transposed
conv carries ``[B, C_out, pt]``, LSTM ``(h, c)`` each ``[B, L, H]`` (the JAX
``[L, B, H]``). ``convert.streaming_state_from_jax`` converts a JAX state.

Constraints (raised as ``ValueError``): a causal model, no audio
normalization, ``trim_right_ratio == 1``, encoder chunks a multiple of the hop
(320 samples = 13.3 ms at 24 kHz), and the first chunk long enough for every
layer's left padding (``min_first_chunk_samples``, 7 latent frames for the
default architecture). The JAX package's per-(shape, first) jit caching has no
counterpart: each call runs eagerly under ``torch.no_grad``.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .models.seanet import SEANetDecoder, SEANetEncoder, SEANetResnetBlock
from .ops.conv import SConv1d, SConvTranspose1d, _biased
from .ops.lstm import SLSTM
from .ops.pad import pad1d

# ------------------------------------------------------------- layer specs


@dataclass(frozen=True)
class ConvSpec:
    name: str
    in_ch: int
    out_ch: int
    kernel: int
    stride: int = 1
    dilation: int = 1

    @property
    def carry_len(self) -> int:
        return (self.kernel - 1) * self.dilation - (self.stride - 1)


@dataclass(frozen=True)
class ConvTrSpec:
    name: str
    in_ch: int
    out_ch: int
    kernel: int
    stride: int

    @property
    def carry_len(self) -> int:
        return self.kernel - self.stride


@dataclass(frozen=True)
class LstmSpec:
    name: str
    dim: int
    num_layers: int


@dataclass(frozen=True)
class BlockSpec:
    """``SEANetResnetBlock``: k3 conv ``dim → hidden`` dilated by
    ``dilation``, k1 conv back, 1×1 shortcut conv."""
    name: str
    dim: int
    hidden: int
    dilation: int = 1

    def convs(self) -> List[ConvSpec]:
        return [ConvSpec('block_1', self.dim, self.hidden, 3, dilation=self.dilation),
                ConvSpec('block_3', self.hidden, self.dim, 1)]


@dataclass(frozen=True)
class ActSpec:
    """An ELU (alpha 1), the only activation the port's SEANet has."""


# --------------------------------------------------------------- layer fns


def _stream_conv(conv: SConv1d, spec: ConvSpec, carry: torch.Tensor, x: torch.Tensor,
                 first: bool, pad_mode: str,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal SConv1d on a chunk, in ``dtype`` by the offline conv's rule
    (``ops.conv._biased``). carry: ``[B, in_ch, pt]`` previous raw input, f32."""
    pt = spec.carry_len
    if first:
        if x.shape[-1] <= pt:
            raise ValueError(f'first chunk too short for {spec.name}: {x.shape[-1]} <= pad {pt}')
        xc = pad1d(x, (pt, 0), mode=pad_mode)
    else:
        xc = torch.cat([carry, x], dim=-1) if pt else x
    weights = conv.conv.conv
    y = _biased(F.conv1d, xc.to(dtype), weights.kernel().to(dtype), weights.bias.to(dtype),
                stride=spec.stride, dilation=spec.dilation)
    if pt:
        tail = x if first else torch.cat([carry, x], dim=-1)
        carry = tail[..., tail.shape[-1] - pt:].float()
    return y, carry


def _stream_convtr(convtr: SConvTranspose1d, spec: ConvTrSpec, carry: torch.Tensor,
                   x: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal SConvTranspose1d (``trim_right_ratio == 1``) on a chunk.

    The raw sum is the f32 sum of the operands cast to ``dtype`` (bf16
    products are exact in f32), so the overlap-add of two chunks' partial
    sums is the offline conv's sum. carry: ``[B, out_ch, pt]`` bias-free
    partial sums for the next chunk's head, f32. Emits ``n·stride`` samples,
    rounded to ``dtype`` and then biased as the offline conv's output is."""
    w = convtr.convtr.convtr
    pt = spec.carry_len
    n = x.shape[-1]
    raw = F.conv_transpose1d(x.to(dtype).float(), w.kernel().to(dtype).float(), None,
                             stride=spec.stride)   # n·s + pt
    emit = raw[..., :n * spec.stride]
    if pt:
        emit = torch.cat([emit[..., :pt] + carry, emit[..., pt:]], dim=-1)
        carry = raw[..., n * spec.stride:]
    return emit.to(dtype) + w.bias.to(dtype)[:, None], carry


def _stream_lstm(slstm: SLSTM, spec: LstmSpec, carry, x: torch.Tensor):
    """SLSTM with an explicit (h, c) carry, each ``[B, L, H]``; f32 always,
    like the offline SLSTM."""
    hs, cs = carry
    in_dtype = x.dtype
    x32 = x.float().permute(2, 0, 1)                     # [T, B, C]
    y = x32
    new_h, new_c = [], []
    for k in range(spec.num_layers):
        y, c = slstm.lstm.recurrence(k, slstm.lstm.projection(k, y), hs[:, k].contiguous(),
                                     cs[:, k].contiguous())
        new_h.append(y[-1])
        new_c.append(c)
    y = y + x32
    return (y.permute(1, 2, 0).to(in_dtype),
            (torch.stack(new_h, dim=1), torch.stack(new_c, dim=1)))


def _stream_block(block: SEANetResnetBlock, spec: BlockSpec, state: Dict[str, torch.Tensor],
                  x: torch.Tensor, first: bool, pad_mode: str, dtype: torch.dtype):
    """One resblock on a chunk. A float32 block of a weight-acting norm is one
    call of K3 (its plain version on the CPU) with the k3 conv's carry as its
    halo, where the offline block takes K3 (``takes_kernel``: gradients are
    off here); any other block (bf16) is the offline block's conv sequence
    with the same carry."""
    if first and x.shape[-1] <= 2 * spec.dilation:
        raise ValueError(f'first chunk too short for block_1: {x.shape[-1]} '
                         f'<= pad {2 * spec.dilation}')
    if block.takes_fused():
        y, carry = block.fused_call(
            x.contiguous(), dilation=spec.dilation, causal=True, pad_mode=pad_mode,
            left=None if first else state['block_1'].contiguous(), return_carry=True)
        return y, {'block_1': carry, 'block_3': state['block_3']}
    k3, k1 = spec.convs()
    y, carry = _stream_conv(block.block[1], k3, state['block_1'], F.elu(x), first, pad_mode,
                            dtype)
    y, _ = _stream_conv(block.block[3], k1, state['block_3'], F.elu(y), first, pad_mode, dtype)
    shortcut, _ = _stream_conv(block.shortcut, ConvSpec('shortcut', spec.dim, spec.dim, 1),
                               state['block_3'], x, first, pad_mode, dtype)
    return shortcut + y, {'block_1': carry, 'block_3': state['block_3']}


# ------------------------------------------------------------ op sequences


def _encoder_ops(enc: SEANetEncoder) -> List[Any]:
    ops: List[Any] = []
    idx, mult = 0, 1
    nf = enc.n_filters
    ops.append(ConvSpec(f'layer_{idx}', enc.channels, mult * nf, enc.model[idx].kernel_size))
    idx += 1
    for ratio in reversed(enc.ratios):
        dim = mult * nf
        ops.append(BlockSpec(f'layer_{idx}', dim, dim // 2, enc.model[idx].dilation))
        idx += 1
        ops.append(ActSpec())
        idx += 1
        ops.append(ConvSpec(f'layer_{idx}', dim, dim * 2, ratio * 2, stride=ratio))
        idx += 1
        mult *= 2
    ops.append(LstmSpec(f'layer_{idx}', mult * nf, enc.model[idx].lstm.num_layers))
    idx += 1
    ops.append(ActSpec())
    idx += 1
    ops.append(ConvSpec(f'layer_{idx}', mult * nf, enc.dimension, enc.model[idx].kernel_size))
    return ops


def _decoder_ops(dec: SEANetDecoder) -> List[Any]:
    ops: List[Any] = []
    idx = 0
    nf = dec.n_filters
    mult = 2 ** len(dec.ratios)
    ops.append(ConvSpec(f'layer_{idx}', dec.dimension, mult * nf, dec.model[idx].kernel_size))
    idx += 1
    ops.append(LstmSpec(f'layer_{idx}', mult * nf, dec.model[idx].lstm.num_layers))
    idx += 1
    for ratio in dec.ratios:
        ops.append(ActSpec())
        idx += 1
        ops.append(ConvTrSpec(f'layer_{idx}', mult * nf, mult * nf // 2, ratio * 2, ratio))
        idx += 1
        dim = mult * nf // 2
        ops.append(BlockSpec(f'layer_{idx}', dim, dim // 2, dec.model[idx].dilation))
        idx += 1
        mult //= 2
    ops.append(ActSpec())
    idx += 1
    ops.append(ConvSpec(f'layer_{idx}', nf, dec.channels, dec.model[idx].kernel_size))
    return ops


# ----------------------------------------------------------- the streamers


class StreamingSEANet:
    """Streaming interpreter over a causal SEANetEncoder/SEANetDecoder:
    ``apply(state, x, first=...)`` → ``(y, state)``. ``first=True`` reproduces
    offline's left padding instead of using the (zero) carry."""

    def __init__(self, module):
        if not module.causal:
            raise ValueError('streaming requires a causal model')
        if isinstance(module, SEANetEncoder):
            self.ops = _encoder_ops(module)
        else:
            if not isinstance(module, SEANetDecoder):
                raise TypeError(f'cannot stream a {type(module).__name__}')
            if any(getattr(m, 'trim_right_ratio', 1.) != 1. for m in module.model):
                raise ValueError('streaming decoder requires trim_right_ratio == 1')
            self.ops = _decoder_ops(module)
        self.module = module
        self.dtype = module.dtype
        self.pad_mode = module.pad_mode

    def _layer(self, op):
        return self.module.model[int(op.name.split('_')[1])]

    @property
    def min_first_chunk(self) -> int:
        """Minimum FIRST-chunk length (in this module's input timebase) so
        every conv's left pad fits inside the chunk (reflect constraint)."""
        need = 1
        scale = 1  # cumulative downsampling factor so far
        for op in self.ops:
            if isinstance(op, ConvSpec):
                need = max(need, (op.carry_len + 1) * scale)
                scale *= op.stride
            elif isinstance(op, BlockSpec):
                for c in op.convs():
                    need = max(need, (c.carry_len + 1) * scale)
            elif isinstance(op, ConvTrSpec):
                scale = max(1, scale // op.stride)
        return need

    def init_state(self, batch_size: int) -> Dict[str, Any]:
        device = next(self.module.parameters()).device
        zeros = lambda *shape: torch.zeros(batch_size, *shape, device=device)
        state: Dict[str, Any] = {}
        for op in self.ops:
            if isinstance(op, ConvSpec):
                state[op.name] = zeros(op.in_ch, op.carry_len)
            elif isinstance(op, ConvTrSpec):
                state[op.name] = zeros(op.out_ch, op.carry_len)
            elif isinstance(op, LstmSpec):
                state[op.name] = (zeros(op.num_layers, op.dim), zeros(op.num_layers, op.dim))
            elif isinstance(op, BlockSpec):
                state[op.name] = {c.name: zeros(c.in_ch, c.carry_len) for c in op.convs()}
        return state

    @torch.no_grad()
    def apply(self, state: Dict[str, Any], x: torch.Tensor, first: bool = False):
        new_state = dict(state)
        for op in self.ops:
            if isinstance(op, ActSpec):
                x = F.elu(x)
                continue
            layer = self._layer(op)
            if isinstance(op, ConvSpec):
                x, new_state[op.name] = _stream_conv(layer, op, state[op.name], x, first,
                                                     self.pad_mode, self.dtype)
            elif isinstance(op, ConvTrSpec):
                x, new_state[op.name] = _stream_convtr(layer, op, state[op.name], x, self.dtype)
            elif isinstance(op, LstmSpec):
                x, new_state[op.name] = _stream_lstm(layer, op, state[op.name], x)
            else:
                x, new_state[op.name] = _stream_block(layer, op, state[op.name], x, first,
                                                      self.pad_mode, self.dtype)
        return x.float(), new_state


class StreamingCodec:
    """Chunked encode/decode over an ``EncodecModel`` (causal, unnormalized),
    at the bandwidth the model has when the codec is built.

    Usage::

        codec = StreamingCodec(model)                 # bandwidth already set
        enc_state, dec_state = codec.init_state(batch_size=1)
        codes, enc_state = codec.encode_chunk(enc_state, wav, first=True)
        wav_out, dec_state = codec.decode_chunk(dec_state, codes, first=True)
        # ... subsequent chunks with first=False

    ``wav`` chunks are ``[B, C, T]`` with ``T % hop == 0``; the first chunk
    must be at least ``min_first_chunk_samples``.
    """

    def __init__(self, model):
        if model.normalize:
            raise ValueError('streaming requires audio_normalize=False (per-segment scales '
                             'are an offline concept)')
        if getattr(model, 'segment', None) is not None:
            raise ValueError('streaming replaces segment windowing')
        self.model = model
        self.bandwidth = model.bandwidth
        self.hop = model.encoder.hop_length
        self.encoder = StreamingSEANet(model.encoder)
        self.decoder = StreamingSEANet(model.decoder)

    @property
    def min_first_chunk_samples(self) -> int:
        need = max(self.encoder.min_first_chunk, self.decoder.min_first_chunk * self.hop)
        return -(-need // self.hop) * self.hop

    def init_state(self, batch_size: int):
        return self.encoder.init_state(batch_size), self.decoder.init_state(batch_size)

    def _check(self, wav: torch.Tensor):
        if wav.shape[-1] % self.hop:
            raise ValueError(f'chunk length {wav.shape[-1]} must be a multiple of {self.hop}')

    def quantize(self, emb: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, D, t]`` → codes ``[K, B, t]`` (kernel K1 on CUDA)."""
        m = self.model
        return m.quantizer.encode(emb.transpose(1, 2), m.frame_rate, self.bandwidth)

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """Codes ``[K, B, t]`` → latents ``[B, D, t]``."""
        return self.model.quantizer.decode(codes).transpose(1, 2)

    @torch.no_grad()
    def encode_chunk(self, state, wav: torch.Tensor, first: bool = False):
        """wav ``[B, C, T]`` (T % hop == 0) → (codes ``[B, K, T/hop]``, state)."""
        self._check(wav)
        emb, state = self.encoder.apply(state, wav, first=first)
        return self.quantize(emb).transpose(0, 1), state

    @torch.no_grad()
    def decode_chunk(self, state, codes: torch.Tensor, first: bool = False):
        """codes ``[B, K, t]`` → (wav ``[B, C, t·hop]``, state)."""
        return self.decoder.apply(state, self.dequantize(codes.transpose(0, 1)), first=first)

    @torch.no_grad()
    def roundtrip_chunk(self, enc_state, dec_state, wav: torch.Tensor, first: bool = False):
        """Encode, quantize, dequantize and decode one chunk:
        wav ``[B, C, T]`` → (wav_out ``[B, C, T]``, codes ``[B, K, T/hop]``,
        enc_state, dec_state)."""
        self._check(wav)
        emb, enc_state = self.encoder.apply(enc_state, wav, first=first)
        codes = self.quantize(emb)
        y, dec_state = self.decoder.apply(dec_state, self.dequantize(codes), first=first)
        return y, codes.transpose(0, 1), enc_state, dec_state
