"""WAV file IO and resampling for the whole package: the datasets, the
CLIs (through ``utils``), the metrics and data prep.

Port of ``encodec_pytorch_tpu/data/audio_io.py`` (which this package cannot
import: its package pulls in pandas). Samples are read by scipy, memory-mapped
for a ranged read, and scaled as the JAX package scales them, so that a 16-bit,
32-bit or float file reads to the same bits in both packages.

One deviation: scipy refuses to memory-map 3-byte samples (``ValueError:
mmap=True not compatible with 3-byte container size``), which the JAX package's
``wav_info`` and ranged ``read_wav`` both do. Here ``wav_info`` parses the
header itself, and a ranged read of 24-bit PCM reads just its frames' bytes
and widens them to scipy's left-justified int32, the values scipy's full read
gives.
"""

import os
import struct
from fractions import Fraction
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy.io import wavfile

PathLike = Union[str, Path]


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.float32 or data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0)
    raise ValueError(f"unsupported wav dtype {data.dtype}")


def _header(path: PathLike) -> Tuple[int, int, int, int, int, str]:
    """(sample_rate, channels, bytes a frame, offset of the samples, frames,
    byte order) from a RIFF, RIFX or RF64 header, reading no samples."""
    with open(path, 'rb') as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] not in (b'RIFF', b'RIFX', b'RF64') or head[8:] != b'WAVE':
            raise ValueError(f'{path} is not a WAV file')
        order = '>' if head[:4] == b'RIFX' else '<'
        fmt, ds64_size = None, None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                raise ValueError(f'{path} has no data chunk')
            cid, size = chunk[:4], struct.unpack(order + 'I', chunk[4:])[0]
            if cid == b'fmt ':
                _, channels, sr, _, block_align, _ = struct.unpack(order + 'HHIIHH', f.read(16))
                fmt = (sr, channels, block_align)
                f.seek(size - 16 + (size & 1), 1)
            elif cid == b'ds64':
                ds64_size = struct.unpack('<Q', f.read(16)[8:])[0]
                f.seek(size - 16 + (size & 1), 1)
            elif cid == b'data':
                if fmt is None:
                    raise ValueError(f'{path}: data chunk before the fmt chunk')
                if size == 0xFFFFFFFF and ds64_size is not None:
                    size = ds64_size
                sr, channels, block_align = fmt
                return sr, channels, block_align, f.tell(), size // block_align, order
            else:
                f.seek(size + (size & 1), 1)


def wav_info(path: PathLike) -> Tuple[int, int, int]:
    """(sample_rate, n_frames, n_channels) from the header, without loading
    or memory-mapping samples."""
    sr, channels, _, _, frames, _ = _header(path)
    return sr, frames, channels


def _read_pcm24(path: PathLike, header, start: int, end: Optional[int]) -> np.ndarray:
    """Frames ``[start, end)`` of 3-byte PCM as ``[T, C]`` int32, left-justified
    as scipy's full read gives them (the sample in the top 24 bits)."""
    _, channels, block_align, offset, frames, order = header
    first, last = slice(start, end).indices(frames)[:2]
    n = max(0, last - first)
    with open(path, 'rb') as f:
        f.seek(offset + first * block_align)
        raw = np.frombuffer(f.read(n * block_align), np.uint8).reshape(-1, 3)
    wide = np.zeros((raw.shape[0], 4), np.uint8)
    if order == '<':
        wide[:, 1:] = raw
    else:
        wide[:, :3] = raw
    return wide.view(order + 'i4').reshape(n, channels).astype(np.int32)


def read_wav(path: PathLike, start: int = 0,
             frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read (a slice of) a wav file → (wav ``[C, T]`` float32, sample_rate).

    ``start``/``frames`` slice without loading the whole file: the samples
    are memory-mapped, or for 3-byte PCM only the slice's bytes are read.
    """
    end = None if frames is None else start + frames
    header = _header(path)
    sr, channels, block_align = header[:3]
    if block_align == 3 * channels:
        data = _read_pcm24(path, header, start, end)
    else:
        sr, data = wavfile.read(str(path), mmap=True)
        data = np.array(data[start:end])
    data = _pcm_to_float(data)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # [T, C] -> [C, T]
    return np.ascontiguousarray(data), sr


def write_wav(path: PathLike, wav: np.ndarray, sample_rate: int) -> None:
    """Write ``[C, T]`` float in [-1, 1] as 16-bit PCM."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None, :]
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16).T   # [T, C]
    if pcm.shape[1] == 1:
        pcm = pcm[:, 0]
    os.makedirs(os.path.dirname(os.path.abspath(str(path))) or '.', exist_ok=True)
    wavfile.write(str(path), sample_rate, pcm)


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis (float64, cast to float32)."""
    if sr == target_sr:
        return np.asarray(wav, np.float32)
    from scipy.signal import resample_poly   # ~2 s to import; only resampling needs it
    frac = Fraction(target_sr, sr)
    out = resample_poly(np.asarray(wav, np.float64), frac.numerator,
                        frac.denominator, axis=-1)
    return out.astype(np.float32)
