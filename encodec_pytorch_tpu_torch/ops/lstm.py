"""Multi-layer LSTM bottleneck with a residual skip (SLSTM).

Port of ``encodec_pytorch_tpu/ops/lstm.py``. Each layer's input projection
``x @ W_ihᵀ + (b_ih + b_hh)`` for all timesteps is one ``torch.matmul``
outside the kernel, as in the JAX package; the recurrence goes through
:func:`..ops.lstm_kernel.lstm_recurrence` (kernel K2 on CUDA). The LSTM always
computes in f32. Only the sum of the two biases enters the math, so a
checkpoint exported with ``bias_hh = 0`` gives the same output. The JAX
package trains that sum as one parameter; here ``bias_ih`` is the trained
parameter and ``bias_hh`` a buffer (zero at init, a released checkpoint's
value once loaded), so a step moves the sum exactly as the JAX step does.

Parameters are named as torch's ``nn.LSTM`` names them
(``lstm.weight_ih_l{k}`` and so on) but live in a plain holder module: the
port never calls cuDNN's LSTM.

Training on CUDA goes through :func:`recurrence`, a ``torch.autograd.Function``
whose forward is kernel K2 and whose backward recomputes the recurrence with
the plain torch loop (``lstm_recurrence_reference``) and takes its autograd.
That is the JAX package's design: a Pallas forward with a rematerialized scan
backward (``encodec_pytorch_tpu/ops/lstm.py`` ``_fused_lstm_layer``); the JAX
package has no LSTM backward kernel, so none is ported. A hand-written
backward kernel is later work (``ROADMAP.md`` Queue 2).
"""

from typing import Optional, Tuple

import torch
from torch import nn

from . import custom, lstm_kernel
from .int8 import dequantize_int8, quantize_int8


class _LSTMWeights(nn.Module):
    """``weight_ih_l{k} [4H, in]``, ``weight_hh_l{k} [4H, H]``,
    ``bias_ih_l{k}``, ``bias_hh_l{k} [4H]``; the parameters uniform in
    ``±1/sqrt(H)`` (the JAX package's init), ``bias_hh`` a zero buffer.

    The int8 form (:meth:`quantize_int8`, for serving) keeps each matrix as
    the buffers ``weight_{ih,hh}_l{k}_q8`` (int8) and ``..._scale`` (f32, one
    a gate row): the input projection dequantizes ``w_ih`` in
    ``dequant_dtype`` and stays ``torch.matmul``; ``W_hh`` goes to kernel K2's
    int8 entry (:func:`..ops.lstm_kernel.lstm_recurrence_int8`) as it is, or,
    when ``prepare.quantized_call`` dequantizes in bf16, to the f32 entry as
    the f32 up-cast of the bf16 product (the JAX package's arithmetic)."""

    def __init__(self, dimension: int, num_layers: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        H = dimension
        bound = 1.0 / H ** 0.5

        def param(*shape):
            return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))

        self.num_layers = num_layers
        self.int8 = False
        self.dequant_dtype = torch.float32
        for k in range(num_layers):
            setattr(self, f'weight_ih_l{k}', param(4 * H, H))
            setattr(self, f'weight_hh_l{k}', param(4 * H, H))
            setattr(self, f'bias_ih_l{k}', param(4 * H))
            self.register_buffer(f'bias_hh_l{k}', torch.zeros(4 * H))

    def quantize_int8(self) -> None:
        """Replace every weight matrix by its int8 form."""
        if self.int8:
            raise ValueError('the LSTM weights are int8 already')
        for k in range(self.num_layers):
            for name in (f'weight_ih_l{k}', f'weight_hh_l{k}'):
                q8, scale = quantize_int8(getattr(self, name))
                delattr(self, name)
                self.register_buffer(f'{name}_q8', q8)
                self.register_buffer(f'{name}_scale', scale)
        self.int8 = True

    def _weight(self, name: str) -> torch.Tensor:
        """A weight matrix in f32 (an int8 one dequantized in ``dequant_dtype``)."""
        if not self.int8:
            return getattr(self, name)
        return dequantize_int8(getattr(self, f'{name}_q8'), getattr(self, f'{name}_scale'),
                               self.dequant_dtype).float()

    def projection(self, k: int, y: torch.Tensor) -> torch.Tensor:
        """Layer ``k``'s input projection ``y @ W_ihᵀ + (b_ih + b_hh)``,
        ``[T, B, 4H]``, as one 2-D product over the ``T·B`` rows: the route
        ``torch.matmul`` takes for a weight that requires a gradient, whatever
        ``y``'s strides, so that an int8 twin's dequantized ``W_ih`` (no
        gradient) sums as the float model's parameter does."""
        b = getattr(self, f'bias_ih_l{k}') + getattr(self, f'bias_hh_l{k}')
        T, B, C = y.shape
        xp = torch.matmul(y.reshape(T * B, C), self._weight(f'weight_ih_l{k}').t())
        return (xp.reshape(T, B, -1) + b).contiguous()

    def recurrence(self, k: int, xp: torch.Tensor, h0: Optional[torch.Tensor] = None,
                   c0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Layer ``k``'s hidden states ``[T, B, H]`` and, from a carried
        ``(h0, c0)``, its final cell state (None from the zero state, where a
        gradient may flow through :func:`recurrence`)."""
        if self.int8 and self.dequant_dtype == torch.float32:
            name = f'weight_hh_l{k}'
            return lstm_kernel.lstm_recurrence_int8(xp, getattr(self, f'{name}_q8'),
                                                    getattr(self, f'{name}_scale'), h0, c0)
        w_hh = self._weight(f'weight_hh_l{k}').contiguous()
        if h0 is None and c0 is None:
            return recurrence(xp, w_hh), None
        return lstm_kernel.lstm_recurrence(xp, w_hh, h0, c0)


class _Recurrence(torch.autograd.Function):
    """K2 forward; backward through a recomputed plain recurrence."""

    @staticmethod
    def forward(ctx, xp, w_hh):
        ctx.save_for_backward(xp, w_hh)
        return lstm_kernel.lstm_recurrence(xp, w_hh)[0]

    @staticmethod
    def backward(ctx, grad_h):
        xp, w_hh = ctx.saved_tensors
        with torch.enable_grad():
            inputs = (xp.detach().requires_grad_(ctx.needs_input_grad[0]),
                      w_hh.detach().requires_grad_(ctx.needs_input_grad[1]))
            h, _ = lstm_kernel.lstm_recurrence_reference(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(h, wanted, grad_h))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def recurrence(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Hidden states ``[T, B, H]``: the plain loop (and its autograd) for CPU
    tensors; kernel K2 for CUDA tensors, through :class:`_Recurrence` when a
    gradient is needed; the ``encodec::lstm_recurrence`` operator when traced
    without one (``ops/custom.py``)."""
    needs_grad = torch.is_grad_enabled() and (xp.requires_grad or w_hh.requires_grad)
    if custom.tracing() and not needs_grad:
        return torch.ops.encodec.lstm_recurrence(xp, w_hh)
    if xp.device.type == 'cpu':
        return lstm_kernel.lstm_recurrence_reference(xp, w_hh)[0]
    if needs_grad:
        return _Recurrence.apply(xp, w_hh)
    return lstm_kernel.lstm_recurrence(xp, w_hh)[0]


class SLSTM(nn.Module):
    """LSTM over ``[B, C, T]`` plus the input (skip connection); returns
    ``[B, C, T]``.

    Trainable on CUDA through :func:`recurrence`.
    """

    def __init__(self, dimension: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lstm = _LSTMWeights(dimension, num_layers, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.float().permute(2, 0, 1)          # [T, B, C]
        y = x
        for k in range(self.lstm.num_layers):
            y = self.lstm.recurrence(k, self.lstm.projection(k, y))[0]
        return (y + x).permute(1, 2, 0).to(in_dtype)
