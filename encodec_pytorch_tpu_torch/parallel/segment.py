"""Segment-parallel codec inference.

Port of ``encodec_pytorch_tpu/parallel/segment.py``. A segmented model (the
48 kHz family) codes a clip in 1 s segments that the reference runs one after
the other (model.py:122-145) and overlap-adds (utils.py:22-61). The segments
are independent: here the full ones are folded into the batch axis and go
through one encode (one decode), the ragged tail through a call of its own, so
the frames equal the sequential encoder's up to f32 near-ties (as
``EncodecModel.encode_segmajor``'s do).

Across ranks (``dp``, a :class:`~.mesh.DataParallel`; the JAX package's
``mesh`` argument): every rank calls with the same ``x``. When the number of
full segments divides by the world size (the JAX package's gate), rank ``r``
codes the contiguous block ``[r·S/n, (r+1)·S/n)`` of them, and the codes and
scales (the decoded waves, for :func:`decode_parallel`) come back to every
rank in rank order through :meth:`~.mesh.DataParallel.all_gather`; otherwise
every rank codes every segment. Every rank returns the same frames.

Launch: one process a card under ``torchrun`` (NCCL), or gloo on the CPU;
:func:`~.mesh.initialize_distributed` gives the handle.
"""

from typing import List, Optional

import torch

from ..utils import linear_overlap_add
from .mesh import DataParallel


def _share(dp: Optional[DataParallel], n_segments: int) -> Optional[slice]:
    """This rank's block of ``n_segments`` full segments, or None when every
    rank codes them all (one process, or a count the ranks do not divide)."""
    if dp is None or dp.world == 1 or n_segments % dp.world:
        return None
    per = n_segments // dp.world
    return slice(dp.rank * per, (dp.rank + 1) * per)


def _gather(dp: DataParallel, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t [s, ...]`` (a block of segments), concatenated in rank
    order, on ``t``'s device."""
    table = dp.all_gather(t.to(dp.device))
    return table.reshape(-1, *t.shape[1:]).to(t.device)


@torch.no_grad()
def encode_parallel(model, x: torch.Tensor, dp: Optional[DataParallel] = None) -> list:
    """:meth:`EncodecModel.encode` with every full segment in one call (on
    ``dp``, this rank's block of them): ``[B, C, T]`` → one frame
    ``(codes [B, K, T'], scale [B, 1] or None)`` a segment."""
    if model.segment_length is None:
        return model.encode(x)
    model._check_wav(x)
    B, channels, length = x.shape
    L, stride = model.segment_length, model.segment_stride
    offsets = list(range(0, length, stride))
    n_full = len([o for o in offsets if o + L <= length])
    frames: List = []
    if n_full:
        block = _share(dp, n_full)
        windows = x.unfold(-1, L, stride)[:, :, :n_full].permute(2, 0, 1, 3)   # [S, B, C, L]
        if block is not None:
            windows = windows[block]
        s = windows.shape[0]
        codes, scale = model._encode_frame(windows.reshape(s * B, channels, L))
        codes = codes.reshape(s, B, *codes.shape[1:])                         # [s, B, K, T']
        scale = None if scale is None else scale.reshape(s, B, 1)
        if block is not None:
            codes = _gather(dp, codes)
            scale = None if scale is None else _gather(dp, scale)
        frames += [(codes[i], None if scale is None else scale[i]) for i in range(n_full)]
    frames += [model._encode_frame(x[:, :, o:o + L]) for o in offsets[n_full:]]
    return frames


@torch.no_grad()
def decode_parallel(model, frames: list, dp: Optional[DataParallel] = None) -> torch.Tensor:
    """:meth:`EncodecModel.decode` with the leading frames of the first
    frame's shape (the full segments) in one call (on ``dp``, this rank's
    block of them), then the triangular overlap-add."""
    if model.segment_length is None:
        return model.decode(frames)
    shape = frames[0][0].shape
    n_full = 0
    while n_full < len(frames) and frames[n_full][0].shape == shape:
        n_full += 1
    block = _share(dp, n_full)
    picked = range(n_full)[block] if block is not None else range(n_full)
    codes = torch.cat([frames[i][0] for i in picked])                            # [s·B, K, T']
    scale = None if frames[0][1] is None else torch.cat([frames[i][1] for i in picked])
    wav = model._decode_frame((codes, scale))
    wav = wav.reshape(len(picked), shape[0], *wav.shape[1:])                      # [s, B, C, L]
    if block is not None:
        wav = _gather(dp, wav)
    decoded = [wav[i] for i in range(n_full)]
    decoded += [model._decode_frame(f) for f in frames[n_full:]]
    return linear_overlap_add(decoded, model.segment_stride or 1)


def roundtrip_parallel(model, x: torch.Tensor, dp: Optional[DataParallel] = None
                       ) -> torch.Tensor:
    """Segment-parallel ``model(x)``: encode, decode, cut to ``x``'s length."""
    frames = encode_parallel(model, x, dp)
    return decode_parallel(model, frames, dp)[:, :, :x.shape[-1]]
