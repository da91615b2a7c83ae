"""Kernels K1, K2 and K3 as torch custom operators, for traced programs.

``torch.export`` (``deploy.py``) and ``torch.compile`` trace the model with
fake tensors. Each kernel wrapper picks its route in Python from the device of
the tensors it is given (the plain version for a CPU tensor, the CUDA kernel
for a CUDA one), so a trace would record the plain version's aten ops, the
RVQ's argmax search and the LSTM's recurrence unrolled step by step, and the
traced program would run them on the card too. While tracing
(:func:`tracing`), the model's call sites call these operators instead
(``quantization/core_vq.py``, ``ops/lstm.py``, ``models/seanet.py``): the
graph then holds one ``encodec::*`` node a kernel call, whatever device it
was traced on. Run, a node calls the kernel's wrapper: on a CPU tensor its
plain version, on a CUDA tensor the kernel, counted in the wrapper's
``launches`` as a direct call is. Each operator's fake implementation gives
the output's shape from its inputs' shapes alone, so the batch (and K1's rows
``M = B·T``) may be symbolic.

- ``encodec::rvq_encode(x [B, T, D], embed [K, N, D], esq [K, N])`` → codes
  ``[K, B, T]`` int32 (:func:`.rvq_kernel.rvq_encode`);
- ``encodec::lstm_recurrence(xp [T, B, 4H], w_hh [4H, H])`` → ``[T, B, H]``,
  from the zero state (:func:`.lstm_kernel.lstm_recurrence`);
- ``encodec::resblock(x [B, C, T], k1, b1, k2, b2, ks, bs, dilation, causal,
  pad_mode)`` → ``[B, C, T]`` (:func:`.resblock_kernel.resblock`).

The live paths (``LiveCodec``, the streaming servers, training) keep calling
the wrappers directly and pay no dispatcher cost. The int8-weight entries have
no operator: deployed programs refuse int8 weights (``deploy.py``).

One operator is not a kernel: ``encodec::group_norm`` (``time_group_norm``'s
one-group GroupNorm, ``ops/conv.py``) runs ``F.group_norm`` as the live path
does; traced as it is, torch's decomposition of it under a symbolic batch
takes ~0.1 s of tracing a call, a quarter of a 48 kHz program's export.
"""

import functools

import torch
import torch.nn.functional as F

from . import lstm_kernel, resblock_kernel, rvq_kernel

_DEVICES = ('cpu', 'cuda')


def tracing() -> bool:
    """Whether the model is being traced (``torch.export``, ``torch.compile``)."""
    return torch.compiler.is_compiling()


def no_grad(fn):
    """``torch.no_grad()`` as a decorator that switches nothing when
    gradients are off already: a trace records every switch as a node and
    spends a quarter of an export's time taking them out again."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        with torch.no_grad():
            return fn(*args, **kwargs)
    return wrapper


@torch.library.custom_op('encodec::rvq_encode', mutates_args=(), device_types=_DEVICES)
def rvq_encode(x: torch.Tensor, embed: torch.Tensor, esq: torch.Tensor) -> torch.Tensor:
    return rvq_kernel.rvq_encode(x, embed.contiguous(), esq.contiguous())


@rvq_encode.register_fake
def _(x, embed, esq):
    return x.new_empty((embed.shape[0], *x.shape[:-1]), dtype=torch.int32)


@torch.library.custom_op('encodec::lstm_recurrence', mutates_args=(), device_types=_DEVICES)
def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    return lstm_kernel.lstm_recurrence(xp.contiguous(), w_hh.contiguous())[0]


@lstm_recurrence.register_fake
def _(xp, w_hh):
    return xp.new_empty((xp.shape[0], xp.shape[1], w_hh.shape[1]))


@torch.library.custom_op('encodec::resblock', mutates_args=(), device_types=_DEVICES)
def resblock(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
             b2: torch.Tensor, ks: torch.Tensor, bs: torch.Tensor, dilation: int,
             causal: bool, pad_mode: str) -> torch.Tensor:
    tensors = [t.contiguous() for t in (x, k1, b1, k2, b2, ks, bs)]
    return resblock_kernel.resblock(*tensors, dilation=dilation, causal=causal,
                                    pad_mode=pad_mode)


@resblock.register_fake
def _(x, k1, b1, k2, b2, ks, bs, dilation, causal, pad_mode):
    return torch.empty_like(x)


@torch.library.custom_op('encodec::group_norm', mutates_args=(), device_types=_DEVICES)
def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    return F.group_norm(x, 1, weight, bias, eps)


@group_norm.register_fake
def _(x, weight, bias, eps):
    return torch.empty_like(x)
