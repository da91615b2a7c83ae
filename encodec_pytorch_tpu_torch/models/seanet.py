"""SEANet encoder and decoder.

Port of ``encodec_pytorch_tpu/models/seanet.py`` in torch's NCT layout. Each
network is an ``nn.Sequential`` named ``model`` whose indices match the
reference torch layout (``model.{i}...``) that
``encodec_pytorch_tpu/export.py`` writes; activation slots take an index and
hold no parameters.

Only what the model factories set is a parameter here (channels, width,
ratios, norm, causality, pad mode, compute dtype; the norm and the dtype
reach every conv); the rest of the architecture is the
JAX package's default: one residual block per stage with kernels (3, 1)
and dilation 1, a 1×1 conv shortcut, channel compression 2, ELU(1.0),
7-wide first and last convs, a 2-layer LSTM and 128-d latents. With ratios
(8, 5, 4, 2) the hop is 320: 75 frames a second at 24 kHz.

In bfloat16 (the JAX package's activation pipeline) the activations between
layers are bf16, the LSTM computes in f32 behind its own casts, and the
encoder's latent and the decoder's waveform are cast to f32 at the
boundaries (``encodec_pytorch_tpu/models/seanet.py:165-167``, ``:254``), so
the quantizer and the losses see f32.
"""

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import custom, resblock_kernel
from ..ops.conv import SConv1d, SConvTranspose1d
from ..ops.lstm import SLSTM

DIMENSION = 128
KERNEL_SIZE = 7
RESIDUAL_KERNEL_SIZE = 3
COMPRESS = 2
LSTM_LAYERS = 2
# the norms whose convs K3 fuses: they act on the weights only
FUSABLE_NORMS = ('weight_norm', 'none')


class SEANetResnetBlock(nn.Module):
    """``block``: [ELU, k3 conv to dim//2, ELU, k1 conv back to dim], plus
    ``shortcut``: a 1×1 conv.

    Two paths, chosen by where the call runs, the norm and the dtype, never
    as a fallback (:meth:`takes_kernel`): on CUDA with gradients off
    (``encode``/``decode``, the CLI, the servers, streaming) a float32 block
    whose convs are ``weight_norm`` or ``none`` is one launch of kernel K3
    (:func:`..ops.resblock_kernel.resblock`) on the materialised weights;
    otherwise (the CPU; training, which needs autograd, as the JAX package's
    training never reaches its Pallas block either; ``time_group_norm``
    blocks, whose GroupNorms K3 cannot fuse, as the JAX package's
    ``pallas_resblock`` cannot; and bfloat16 blocks, since the TPU kernel K3
    ports is f32 only, its output and scratch f32 at ``pallas_resblock.py:109-111``)
    it is the conv sequence. K3 raises rather than fall back.

    In the int8 twin of ``prepare.py`` (its convs' weights int8, dequantized
    in f32) the same routing sends the block to K3's int8-weight entry
    (:func:`..ops.resblock_kernel.resblock_int8`), which dequantizes each
    weight before its product and so gives the f32 kernel's bits on the
    dequantized weights. When ``prepare.quantized_call`` dequantizes in
    another dtype, the block is its conv sequence."""

    def __init__(self, dim: int, norm: str, causal: bool, pad_mode: str,
                 generator: Optional[torch.Generator], dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = dim // COMPRESS
        conv = dict(norm=norm, causal=causal, pad_mode=pad_mode, generator=generator,
                    dtype=dtype)
        self.block = nn.Sequential(nn.ELU(), SConv1d(dim, hidden, RESIDUAL_KERNEL_SIZE, **conv),
                                   nn.ELU(), SConv1d(hidden, dim, 1, **conv))
        self.shortcut = SConv1d(dim, dim, 1, **conv)
        self.causal, self.pad_mode = causal, pad_mode
        self.fusable = norm in FUSABLE_NORMS and dtype == torch.float32
        self.dilation = self.block[1].conv.dilation
        self._convs = (self.block[1].conv.conv, self.block[3].conv.conv, self.shortcut.conv.conv)
        self._fused = None

    @property
    def int8(self) -> bool:
        return self._convs[0].int8

    def fused_weights(self):
        """``(k1, b1, k2, b2, ks, bs)`` with weight norm applied, in K3's
        layout; for an int8 block ``(k1_q8, s1, b1, k2_q8, s2, b2, ks_q8, ss,
        bs)``, the int8 weights with their scales. Cached until a parameter
        or buffer is replaced, moved or changed in place; computed in the
        traced program while the model is traced."""
        if custom.tracing():
            return self._weights()
        key = tuple((t.data_ptr(), t._version) for c in self._convs
                    for t in (*c._parameters.values(), *c._buffers.values()))
        if self._fused is None or self._fused[0] != key:
            self._fused = (key, self._weights())
        return self._fused[1]

    @custom.no_grad
    def _weights(self) -> tuple:
        weights = []
        for c in self._convs:
            if c.int8:
                weights += [c.weight_q8.contiguous(), c.weight_scale, c.bias.detach()]
            else:
                weights += [c.kernel().contiguous(), c.bias.detach()]
        return tuple(weights)

    def takes_fused(self) -> bool:
        """Whether the block runs as one fused call (K3, or its plain version
        on the CPU): float32 blocks of a norm that acts on the weights, and
        int8 ones only while they dequantize in f32."""
        return self.fusable and (not self.int8
                                 or self._convs[0].dequant_dtype == torch.float32)

    def takes_kernel(self, device_type: str) -> bool:
        """Whether a call on ``device_type`` in the current grad mode runs K3
        (on any device while the model is traced: the ``encodec::resblock``
        operator, ``ops/custom.py``)."""
        return (self.takes_fused() and not torch.is_grad_enabled()
                and (device_type == 'cuda' or (custom.tracing() and not self.int8)))

    def fused_call(self, x: torch.Tensor, **kwargs):
        """The fused block on ``x`` (K3 on CUDA, its int8-weight entry for an
        int8 block, the ``encodec::resblock`` operator while traced);
        ``kwargs`` go to the kernel's wrapper."""
        if custom.tracing() and not self.int8 and not kwargs:
            return torch.ops.encodec.resblock(x, *self.fused_weights(), self.dilation,
                                              self.causal, self.pad_mode)
        fn = resblock_kernel.resblock_int8 if self.int8 else resblock_kernel.resblock
        kw = dict(dilation=self.dilation, causal=self.causal, pad_mode=self.pad_mode)
        return fn(x, *self.fused_weights(), **dict(kw, **kwargs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_kernel(x.device.type):
            return self.fused_call(x.contiguous())
        return self.shortcut(x) + self.block(x)


class SEANetEncoder(nn.Module):
    """``[B, channels, T]`` → ``[B, 128, ceil(T/hop)]``. Ratios apply in
    reverse order."""

    def __init__(self, channels: int = 1, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), norm: str = 'weight_norm',
                 causal: bool = False, pad_mode: str = 'reflect',
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dimension = DIMENSION
        self.ratios = list(ratios)
        self.channels, self.n_filters = channels, n_filters
        self.causal, self.pad_mode, self.dtype = causal, pad_mode, dtype
        conv = dict(norm=norm, causal=causal, pad_mode=pad_mode, generator=generator,
                    dtype=dtype)
        mult = 1
        model: list = [SConv1d(channels, n_filters, KERNEL_SIZE, **conv)]
        for ratio in reversed(self.ratios):
            model += [SEANetResnetBlock(mult * n_filters, **conv), nn.ELU(),
                      SConv1d(mult * n_filters, mult * n_filters * 2, kernel_size=ratio * 2,
                              stride=ratio, **conv)]
            mult *= 2
        model += [SLSTM(mult * n_filters, LSTM_LAYERS, generator=generator), nn.ELU(),
                  SConv1d(mult * n_filters, DIMENSION, KERNEL_SIZE, **conv)]
        self.model = nn.Sequential(*model)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The latent, f32 whatever the compute dtype."""
        return self.model(x).float()


class SEANetDecoder(nn.Module):
    """``[B, 128, T']`` → ``[B, channels, T'·hop]``."""

    def __init__(self, channels: int = 1, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), norm: str = 'weight_norm',
                 causal: bool = False, pad_mode: str = 'reflect',
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dimension = DIMENSION
        self.ratios = list(ratios)
        self.channels, self.n_filters = channels, n_filters
        self.causal, self.pad_mode, self.dtype = causal, pad_mode, dtype
        conv = dict(norm=norm, causal=causal, generator=generator, dtype=dtype)
        mult = 2 ** len(ratios)
        model: list = [SConv1d(DIMENSION, mult * n_filters, KERNEL_SIZE, pad_mode=pad_mode,
                               **conv),
                       SLSTM(mult * n_filters, LSTM_LAYERS, generator=generator)]
        for ratio in ratios:
            model += [nn.ELU(),
                      SConvTranspose1d(mult * n_filters, mult * n_filters // 2,
                                       kernel_size=ratio * 2, stride=ratio, **conv),
                      SEANetResnetBlock(mult * n_filters // 2, pad_mode=pad_mode, **conv)]
            mult //= 2
        model += [nn.ELU(), SConv1d(n_filters, channels, KERNEL_SIZE, pad_mode=pad_mode, **conv)]
        self.model = nn.Sequential(*model)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """The waveform, f32 whatever the compute dtype."""
        return self.model(z).float()
