"""Weight-normed 1-D convolutions with streamable (causal/asymmetric) padding,
and the discriminator's 2-D convolution.

Port of ``encodec_pytorch_tpu/ops/conv.py`` for the ``weight_norm``,
``none`` and ``time_group_norm`` norms, in torch's NCT and NCHW layouts. The
1-D convolutions are ``F.conv1d`` / ``F.conv_transpose1d``: the JAX package
ran them outside any Pallas kernel too. ``time_group_norm`` is a GroupNorm
with one group over (C, T) of each sample (eps 1e-5, f32) after the conv and
its bias, under ``norm`` (``conv.norm.weight``/``bias``, ``convtr.norm.*``
in the released layout); a causal conv refuses it, as the JAX package does.
``layer_norm``, ``time_layer_norm`` and ``spectral_norm`` are not ported.

``NormConv2d`` routes the discriminator's F-stride-2 convs to kernel K5
(``ops/disc_im2col_kernel.py``) when ``disc_im2col`` is set, the other convs
that the JAX package sends to its Pallas kernel (``v2_ok``) to kernel K4
(``ops/disc_conv_kernel.py``) when ``disc_kernel`` is set, and all others to
``F.conv2d``. The JAX package's F-phase packed lowering (``fpack``,
``conv2d_pack.py``) is a TPU lane workaround and is not ported.

Parameter names follow the reference torch layout that
``encodec_pytorch_tpu/export.py`` writes: ``conv.conv.weight_v/weight_g/bias``
for ``SConv1d`` and ``convtr.convtr.*`` for ``SConvTranspose1d``. The weight is
``g · v / ‖v‖`` with the norm over every axis but the first, computed in
``forward`` as the JAX package does, so the keys stay those of a released
checkpoint (``torch.nn.utils.parametrizations.weight_norm`` renames them).

Each conv takes a compute ``dtype`` (float32 or bfloat16), the JAX package's
dtype rule (``encodec_pytorch_tpu/ops/conv.py:36-46`` and its conv bodies):
the parameters stay f32 masters and the weight norm runs on them in f32; the
input and the weight are cast to ``dtype``; in bf16 the products are summed
in f32 and the output is stored in bf16, the bias is added after that
rounding, in bf16, and ``time_group_norm`` runs in f32 and is cast back. The
1-D convs stay cuDNN calls in bf16 (the JAX package runs them outside any
Pallas kernel); the 2-D convs routed to K4 and K5 take those kernels' bf16
forms.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import custom, disc_conv_kernel, disc_im2col_kernel
from .int8 import dequantize_int8, quantize_int8
from .pad import get_extra_padding_for_conv1d, pad1d, unpad1d

CONV_NORMALIZATIONS = frozenset(['none', 'weight_norm', 'time_group_norm'])
GROUP_NORM_EPS = 1e-5


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class _ConvWeight(nn.Module):
    """A conv weight, plain (``weight``; ``none`` and ``time_group_norm``) or
    weight-normed (``weight_v`` and ``weight_g``), plus a ``bias``.

    ``shape`` is torch's own weight shape: ``[out, in, k]`` for a conv,
    ``[in, out, k]`` for a transposed conv, ``[out, in, kh, kw]`` for a 2-D
    conv. Weight norm keeps one norm per
    index of the first axis (``weight_norm(dim=0)``). Init is torch's: uniform
    in ``±1/sqrt(fan_in)``, from ``generator``.

    A plain weight has an int8 form (:meth:`quantize_int8`, for serving): the
    buffers ``weight_q8`` (int8, ``shape``) and ``weight_scale`` (f32, one a
    row of dim 0, the JAX layout's trailing axis), and :meth:`kernel`
    dequantizes them in ``dequant_dtype`` (f32 unless
    ``prepare.quantized_call`` asks for the model's compute dtype) each call.
    """

    def __init__(self, shape: Tuple[int, ...], fan_in: int, bias_size: int,
                 norm: str, generator: Optional[torch.Generator]):
        super().__init__()
        if norm not in CONV_NORMALIZATIONS:
            raise NotImplementedError(
                f"norm '{norm}' is not ported yet (only {sorted(CONV_NORMALIZATIONS)})")
        self.norm = norm
        bound = 1.0 / math.sqrt(fan_in)
        weight = _uniform(shape, bound, generator)
        if norm == 'weight_norm':
            self.weight_g = nn.Parameter(_norm_except_dim0(weight))
            self.weight_v = nn.Parameter(weight)
        else:
            self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(_uniform((bias_size,), bound, generator))
        self.int8 = False
        self.dequant_dtype = torch.float32

    def kernel(self) -> torch.Tensor:
        if self.norm == 'weight_norm':
            return self.weight_g * self.weight_v / _norm_except_dim0(self.weight_v)
        if self.int8:
            return dequantize_int8(self.weight_q8, self.weight_scale, self.dequant_dtype)
        return self.weight

    def quantize_int8(self) -> None:
        """Replace the plain ``weight`` by its int8 form."""
        if self.norm != 'none' or self.int8:
            raise ValueError(f"only a plain f32 weight quantizes, not a '{self.norm}' one "
                             f"(int8 already: {self.int8})")
        q8, scale = quantize_int8(self.weight)
        del self.weight
        self.register_buffer('weight_q8', q8)
        self.register_buffer('weight_scale', scale)
        self.int8 = True


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(v), dim=tuple(range(1, v.dim())), keepdim=True))


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def compute_dtype(dtype) -> torch.dtype:
    """A compute dtype from a torch dtype or its name (``'float32'``,
    ``'bfloat16'``); others raise."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f'compute dtype must be float32 or bfloat16, got {dtype}')
    return dtype


def _output_norm(norm: str, channels: int) -> Optional[nn.GroupNorm]:
    """The GroupNorm that ``time_group_norm`` applies to a conv's output (in
    f32, whatever the compute dtype); None for the norms that act on the
    weight."""
    if norm == 'time_group_norm':
        return nn.GroupNorm(1, channels, eps=GROUP_NORM_EPS)
    return None


def _apply_norm(module: Optional[nn.GroupNorm], y: torch.Tensor) -> torch.Tensor:
    """``module(y)`` in f32, cast back to y's dtype (the same call as the
    ``encodec::group_norm`` operator while traced without gradients,
    ``ops/custom.py``)."""
    if module is None:
        return y
    if custom.tracing() and not torch.is_grad_enabled():
        return torch.ops.encodec.group_norm(y.float(), module.weight, module.bias,
                                            module.eps).to(y.dtype)
    return module(y.float()).to(y.dtype)


def _biased(conv, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, **kwargs) -> torch.Tensor:
    """``conv(x, w, bias)`` in x's dtype: in f32 the bias inside the call; in
    bf16 the conv's output rounded to bf16 first, then the bias added in
    bf16. A bf16 conv is cuDNN's on the card; on the CPU it is the f32 conv of
    the bf16 operands rounded to bf16 (the same sums: torch's CPU bf16 conv1d
    returns wrong ones at some strided shapes, e.g. 16 -> 32 channels, kernel
    8, stride 4)."""
    if x.dtype == torch.float32:
        return conv(x, w, bias, **kwargs)
    if x.device.type == 'cpu':
        y = conv(x.float(), w.float(), None, **kwargs).to(x.dtype)
    else:
        y = conv(x, w, None, **kwargs)
    return y + bias.reshape(1, -1, *([1] * (x.dim() - 2)))


class NormConv1d(nn.Module):
    """VALID Conv1d with a normalized weight. ``[B, C_in, T]`` → ``[B, C_out, T']``
    in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, norm: str = 'none',
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.dtype = compute_dtype(dtype)
        self.conv = _ConvWeight((out_channels, in_channels, kernel_size),
                                in_channels * kernel_size, out_channels, norm, generator)
        self.norm = _output_norm(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return _apply_norm(self.norm, _biased(F.conv1d, x.to(d), self.conv.kernel().to(d),
                                              self.conv.bias.to(d), stride=self.stride,
                                              dilation=self.dilation))


class NormConvTranspose1d(nn.Module):
    """ConvTranspose1d with a normalized ``[in, out, k]`` weight; weight norm
    runs over dim 0, the input channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, norm: str = 'none',
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = compute_dtype(dtype)
        self.convtr = _ConvWeight((in_channels, out_channels, kernel_size),
                                  out_channels * kernel_size, out_channels, norm, generator)
        self.norm = _output_norm(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The full transposed conv, normalized before any trim (as in the
        JAX package)."""
        d = self.dtype
        return _apply_norm(self.norm, _biased(F.conv_transpose1d, x.to(d),
                                              self.convtr.kernel().to(d),
                                              self.convtr.bias.to(d), stride=self.stride))


class NormConv2d(nn.Module):
    """Conv2d with a normalized weight over ``[B, C, T, F]`` (time, frequency),
    with symmetric zero ``padding``; parameters under ``conv``
    (``conv.weight_v``/``weight_g`` or ``conv.weight``, ``conv.bias``).

    ``uses_im2col`` is set when ``disc_im2col`` is on and the conv is one
    kernel K5 takes (:func:`..ops.disc_im2col_kernel.eligible`: the 3×9,
    F-stride-2 convs); otherwise ``uses_kernel`` is set when ``disc_kernel``
    is on and the conv is one the JAX package routes to its kernel
    (:func:`..ops.disc_conv_kernel.eligible`). Both kernels run in ``dtype``.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), dilation: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0), norm: str = 'none',
                 disc_kernel: bool = False, disc_im2col: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kh, kw = kernel_size
        self.dtype = compute_dtype(dtype)
        self.stride, self.dilation, self.padding = tuple(stride), tuple(dilation), tuple(padding)
        self.conv = _ConvWeight((out_channels, in_channels, kh, kw), in_channels * kh * kw,
                                out_channels, norm, generator)
        self.norm = _output_norm(norm, out_channels)
        self.uses_im2col = disc_im2col and disc_im2col_kernel.eligible(
            in_channels, out_channels, kernel_size, self.stride, self.dilation, self.padding)
        self.uses_kernel = not self.uses_im2col and disc_kernel and disc_conv_kernel.eligible(
            in_channels, out_channels, kernel_size, self.stride, self.dilation, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        x, w, bias = x.to(d), self.conv.kernel().to(d), self.conv.bias.to(d)
        if self.uses_im2col:
            y = disc_im2col_kernel.disc_im2col(x, w, bias, self.dilation, self.padding)
        elif self.uses_kernel:
            y = disc_conv_kernel.disc_conv(x, w, bias, self.stride, self.dilation, self.padding)
        else:
            y = _biased(F.conv2d, x, w, bias, stride=self.stride, padding=self.padding,
                        dilation=self.dilation)
        return _apply_norm(self.norm, y)


class SConv1d(nn.Module):
    """Conv1d with built-in causal or asymmetric streamable padding.

    ``padding_total = (K-1)·d - (s-1)``; extra end padding keeps the last
    window full so the output has exactly ``ceil(T/stride)`` frames.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, causal: bool = False,
                 norm: str = 'none', pad_mode: str = 'reflect',
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if causal and norm == 'time_group_norm':
            raise ValueError("GroupNorm doesn't support causal evaluation.")
        self.conv = NormConv1d(in_channels, out_channels, kernel_size, stride,
                               dilation, norm, generator, dtype)
        self.kernel_size = kernel_size
        self.causal = causal
        self.pad_mode = pad_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stride = self.conv.stride
        padding_total = (self.kernel_size - 1) * self.conv.dilation - (stride - 1)
        extra_padding = get_extra_padding_for_conv1d(
            x.shape[-1], self.kernel_size, stride, padding_total)
        if self.causal:
            x = pad1d(x, (padding_total, extra_padding), mode=self.pad_mode)
        else:
            padding_right = padding_total // 2
            padding_left = padding_total - padding_right
            x = pad1d(x, (padding_left, padding_right + extra_padding),
                      mode=self.pad_mode)
        return self.conv(x)


class SConvTranspose1d(nn.Module):
    """ConvTranspose1d that trims ``padding_total = K - s`` after the op.

    Causal mode trims ``ceil(padding_total · trim_right_ratio)`` on the
    right and the rest on the left; non-causal splits asymmetrically.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False, norm: str = 'none',
                 trim_right_ratio: float = 1.,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not causal and trim_right_ratio != 1.:
            raise ValueError("`trim_right_ratio` != 1.0 only makes sense for causal convolutions")
        self.convtr = NormConvTranspose1d(in_channels, out_channels, kernel_size,
                                          stride, norm, generator, dtype)
        self.trim_right_ratio = trim_right_ratio
        padding_total = kernel_size - stride
        if causal:
            padding_right = math.ceil(padding_total * trim_right_ratio)
        else:
            padding_right = padding_total // 2
        self.paddings = (padding_total - padding_right, padding_right)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return unpad1d(self.convtr(x), self.paddings)
