"""Overlap-add of decoded segments, and host helpers: channel and rate
conversion, saving audio, checkpoint checksum.

Port of ``encodec_pytorch_tpu/utils.py``. The wav reader, writer and
resampler live in ``data/audio_io.py``; ``read_wav`` and ``write_wav`` are
re-exported here for the CLIs and scripts that take them from ``utils``.
"""

from hashlib import sha256
from pathlib import Path
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .data.audio_io import read_wav, resample, write_wav  # noqa: F401  (re-exported)

PathLike = Union[str, Path]


def linear_overlap_add(frames: Sequence[torch.Tensor], stride: int) -> torch.Tensor:
    """Triangular-weighted overlap-add of decoded segments ``[..., T_i]``
    (equal shapes except possibly the last) placed ``stride`` apart. The
    weight at offset t of a frame of length L is ``0.5 - |t/(L+1) - 0.5|``
    (the interior of a ``linspace`` over L + 2 points), and every output
    position is divided by the summed weight there."""
    if not frames:
        raise ValueError('linear_overlap_add needs at least one frame')
    ref = frames[0]
    total_size = stride * (len(frames) - 1) + frames[-1].shape[-1]
    frame_length = ref.shape[-1]
    t = torch.linspace(0, 1, frame_length + 2, dtype=ref.dtype, device=ref.device)[1:-1]
    weight = 0.5 - (t - 0.5).abs()
    sum_weight = torch.zeros(total_size, dtype=ref.dtype, device=ref.device)
    out = torch.zeros(*ref.shape[:-1], total_size, dtype=ref.dtype, device=ref.device)
    offset = 0
    for frame in frames:
        fl = frame.shape[-1]
        out[..., offset:offset + fl] += weight[:fl] * frame
        sum_weight[offset:offset + fl] += weight[:fl]
        offset += stride
    return out / sum_weight


def convert_audio(wav: np.ndarray, sr: int, target_sr: int,
                  target_channels: int) -> np.ndarray:
    """Channel up/down-mix, then polyphase resample. ``wav``: ``[..., C, T]``."""
    if wav.ndim < 2 or wav.shape[-2] not in (1, 2):
        raise ValueError(f"audio must be [..., C, T] with 1 or 2 channels, got {wav.shape}")
    channels = wav.shape[-2]
    if target_channels == 1:
        wav = wav.mean(-2, keepdims=True)
    elif target_channels == 2 and channels == 1:
        wav = np.broadcast_to(wav, wav.shape[:-2] + (2, wav.shape[-1])).copy()
    elif channels != target_channels:
        raise RuntimeError(f"Impossible to convert from {channels} to {target_channels}")
    return resample(wav, sr, target_sr)


def save_audio(wav: np.ndarray, path: PathLike, sample_rate: int,
               rescale: bool = False) -> None:
    """Save as 16-bit PCM, clamped to ±0.99 or rescaled below it."""
    limit = 0.99
    mx = np.abs(wav).max()
    if rescale:
        wav = wav * min(limit / mx, 1) if mx > 0 else wav
    else:
        wav = np.clip(wav, -limit, limit)
    write_wav(path, wav, sample_rate)


def check_checksum(path: PathLike, checksum: str) -> None:
    """Raise unless the file's sha256 starts with ``checksum``."""
    sha = sha256()
    with open(path, 'rb') as file:
        for buf in iter(lambda: file.read(2 ** 20), b''):
            sha.update(buf)
    actual = sha.hexdigest()[:len(checksum)]
    if actual != checksum:
        raise RuntimeError(f'Invalid checksum for file {path}, '
                           f'expected {checksum} but got {actual}')
