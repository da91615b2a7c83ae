"""LSTM recurrence: the CUDA kernel K2 (``csrc/lstm.cu``) and its plain version.

Port of ``encodec_pytorch_tpu/ops/pallas_lstm.py``. Both functions take the
input projection ``xp [T, B, 4H]`` (``x @ W_ihᵀ + b_ih + b_hh``) and
``w_hh [4H, H]`` in torch's layout, start from ``h0`` and ``c0 [B, H]`` (zero
when not given: the offline path; the streaming codec carries them from chunk
to chunk, as ``encodec_pytorch_tpu/streaming.py`` ``_stream_lstm`` does), and
return every hidden state ``[T, B, H]`` and the final cell state
``c_T [B, H]``; ``h_T`` is the last hidden state. Gate order is torch's:
i, f, g, o.

:func:`lstm_recurrence` launches the kernel for a CUDA tensor and runs the
plain version only for a CPU tensor. :func:`lstm_step_profile` runs the
kernel once with ``clock64`` stamps and reports where a step goes (staging,
the gate dot, the cell update, the grid barrier). The TPU gates
(``H % 128 == 0``, the VMEM ``fits`` budget) were VMEM rules and are not
carried over: the kernel takes any H up to 1024. Forward only: training's
backward recomputes the recurrence with the plain version and takes its
autograd (``ops/lstm.py`` ``_Recurrence``).

:func:`lstm_recurrence_int8` takes ``W_hh`` as the int8 twin holds it
(``prepare.py``): int8 ``[4H, H]`` and an f32 scale a gate row ``[4H]``. The
kernel loads the int8 rows once a launch and forms ``q · scale[row]`` in f32
into the registers the f32 entry loads, so its output is the f32 kernel's on
the dequantized matrix, bit for bit, from a quarter of the bytes (1 MB instead
of 4 at H 512; the carried serving call reloads it every tick). Its plain
version :func:`lstm_recurrence_int8_reference` dequantizes, then runs
:func:`lstm_recurrence_reference`. Forward only: int8 weights serve.
"""

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .int8 import dequantize_int8


def lstm_recurrence_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                              h0: Optional[torch.Tensor] = None,
                              c0: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch recurrence: a Python loop over T."""
    T, B, H4 = xp.shape
    H = H4 // 4
    h = xp.new_zeros(B, H) if h0 is None else h0
    c = xp.new_zeros(B, H) if c0 is None else c0
    w_t = w_hh.t()
    out = []
    for t in range(T):
        gates = xp[t] + torch.matmul(h, w_t)
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    if not out:
        return xp.new_zeros(0, B, H), c
    return torch.stack(out), c


def lstm_recurrence_int8_reference(xp: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor,
                                   h0: Optional[torch.Tensor] = None,
                                   c0: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain int8-``W_hh`` recurrence: ``W_hh`` dequantized in f32, then
    :func:`lstm_recurrence_reference`."""
    return lstm_recurrence_reference(xp, dequantize_int8(w_q8, scale), h0, c0)


def _check(xp, w_hh, h0, c0, scale=None):
    tensors = [t for t in (xp, w_hh, h0, c0, scale) if t is not None]
    if xp.device.type != 'cuda' or any(t.device != xp.device for t in tensors):
        raise ValueError(f'lstm_recurrence: tensors on {[str(t.device) for t in tensors]}; '
                         'all must be on one CUDA device (or all on the CPU)')
    wtype = torch.float32 if scale is None else torch.int8
    if w_hh.dtype != wtype or any(t.dtype != torch.float32 for t in tensors if t is not w_hh):
        raise TypeError(f'lstm_recurrence: w_hh {wtype} and everything else float32, got '
                        f'{[t.dtype for t in tensors]}')
    if scale is not None and scale.shape != w_hh.shape[:1]:
        raise ValueError(f'lstm_recurrence: scale {tuple(scale.shape)} is not one a gate row '
                         f'of w_hh {tuple(w_hh.shape)}')
    if xp.dim() != 3 or xp.shape[2] % 4 or w_hh.shape != (xp.shape[2], xp.shape[2] // 4):
        raise ValueError(f'lstm_recurrence: shapes xp {tuple(xp.shape)} and '
                         f'w_hh {tuple(w_hh.shape)} do not make [T, B, 4H] and [4H, H]')
    T, B, H4 = xp.shape
    H = H4 // 4
    for name, t in (('h0', h0), ('c0', c0)):
        if t is not None and t.shape != (B, H):
            raise ValueError(f'lstm_recurrence: {name} {tuple(t.shape)} is not [B, H] = {(B, H)}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('lstm_recurrence: inputs must be contiguous')


def _launch(xp, w_hh, h0, c0, prof: Optional[torch.Tensor], scale=None):
    """K2's f32 entry, or with ``scale`` its int8-``W_hh`` entry."""
    T, B, H4 = xp.shape
    H = H4 // 4
    out = torch.empty(T, B, H, device=xp.device, dtype=torch.float32)
    c_t = torch.empty(B, H, device=xp.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    lib = _build.load()
    weights = [w_hh.data_ptr()] + ([] if scale is None else [scale.data_ptr()])
    entry = lib.encodec_lstm_recurrence_f32 if scale is None else lib.encodec_lstm_recurrence_i8w
    rc = entry(xp.data_ptr(), *weights, None if h0 is None else h0.data_ptr(),
               None if c0 is None else c0.data_ptr(), out.data_ptr(), c_t.data_ptr(), T, B, H,
               xp.device.index, ctypes.c_void_p(stream),
               None if prof is None else prof.data_ptr())
    _build.check(rc, 'lstm_recurrence kernel')
    return out, c_t


def _empty(xp, c0):
    """T = 0: no launch."""
    B, H = xp.shape[1], xp.shape[2] // 4
    out = torch.empty(0, B, H, device=xp.device, dtype=torch.float32)
    return out, (torch.zeros(B, H, device=xp.device) if c0 is None else c0.clone())


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hidden states ``[T, B, H]`` and final cell state ``[B, H]`` of the
    recurrence; kernel K2 on CUDA."""
    tensors = [t for t in (xp, w_hh, h0, c0) if t is not None]
    if all(t.device.type == 'cpu' for t in tensors):
        return lstm_recurrence_reference(xp, w_hh, h0, c0)
    _check(xp, w_hh, h0, c0)
    if xp.shape[0] == 0:
        return _empty(xp, c0)
    out = _launch(xp, w_hh, h0, c0, None)
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0


def lstm_recurrence_int8(xp: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor,
                         h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lstm_recurrence` with ``W_hh`` int8 ``[4H, H]`` and its f32 row
    scales ``[4H]``; K2's int8-``W_hh`` entry on CUDA."""
    tensors = [t for t in (xp, w_q8, scale, h0, c0) if t is not None]
    if all(t.device.type == 'cpu' for t in tensors):
        return lstm_recurrence_int8_reference(xp, w_q8, scale, h0, c0)
    _check(xp, w_q8, h0, c0, scale)
    if xp.shape[0] == 0:
        return _empty(xp, c0)
    out = _launch(xp, w_q8, h0, c0, None, scale)
    lstm_recurrence_int8.launches += 1
    return out


lstm_recurrence_int8.launches = 0

# the parts of a step that ``lstm_step_profile`` reports, in the kernel's order
STEP_PARTS = ('stage', 'dot', 'update', 'barrier')


def lstm_step_profile(xp: torch.Tensor, w_hh: torch.Tensor,
                      h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None
                      ) -> dict:
    """Where a step of K2 goes, from ``clock64`` stamps that block 0 takes
    each step: the share of the kernel's cycles spent staging h[t-1] and
    xp[t] (``stage``), in the gate dot (``dot``), in the cell update
    (``update``) and waiting at the grid barrier (``barrier``), and the
    cycles of the whole kernel (``cycles``). One launch on CUDA tensors; not
    counted in ``lstm_recurrence.launches`` (not the main path)."""
    _check(xp, w_hh, h0, c0)
    if xp.shape[0] == 0:
        raise ValueError('lstm_step_profile: T must be > 0')
    prof = torch.zeros(5, device=xp.device, dtype=torch.int64)
    _launch(xp, w_hh, h0, c0, prof)
    counts = prof.tolist()
    total = max(counts[4], 1)
    return dict({k: v / total for k, v in zip(STEP_PARTS, counts)}, cycles=counts[4])
