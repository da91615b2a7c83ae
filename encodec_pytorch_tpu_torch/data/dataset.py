"""CSV audio dataset and fixed-length batch loader for training.

Port of ``encodec_pytorch_tpu/data/dataset.py``: the CSV is read with the
``csv`` module (the JAX package's ``data`` package pulls in pandas), wavs
with scipy (``audio_io.read_wav``). Crops are keyed by (seed, epoch, index)
exactly as the JAX package keys them (``_crop_rng``), and the shuffle is
``random.Random(seed + epoch)``, so both packages cut the same crops in the
same order. Batches are ``[B, C, tensor_cut]`` float32 numpy arrays
(``pad_collate``). The loader runs in the caller's thread: no prefetch.
"""

import csv
import logging
import random
from typing import Iterator, Optional, Sequence

import numpy as np

from .audio_io import read_wav, resample

logger = logging.getLogger(__name__)


class CustomAudioDataset:
    """A CSV of wav paths (first column, no header): ``datasets.train_csv_path``
    for ``mode='train'``, ``datasets.test_csv_path`` for ``mode='test'``.

    ``config`` also needs ``datasets.{tensor_cut, fixed_length}`` and
    ``model.{sample_rate, channels}``.
    """

    def __init__(self, config, seed: Optional[int] = None, mode: str = 'train'):
        if mode not in ('train', 'test'):
            raise ValueError(f"dataset mode must be 'train' or 'test', got {mode!r}")
        path = config.datasets.train_csv_path if mode == 'train' else config.datasets.test_csv_path
        with open(path, newline='') as f:
            self.audio_files = [row[0] for row in csv.reader(f) if row and row[0]]
        self.fixed_length = int(config.datasets.fixed_length or 0)
        self.tensor_cut = int(config.datasets.tensor_cut or 0)
        self.sample_rate = int(config.model.sample_rate)
        self.channels = int(config.model.channels)
        self.rng = random.Random()
        self.seed = None if seed is None else int(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _crop_rng(self, idx: int) -> random.Random:
        if self.seed is None:
            return self.rng
        return random.Random((self.seed * 1_000_003 + self.epoch) * 1_000_003 + idx)

    def __len__(self):
        if self.fixed_length and len(self.audio_files) > self.fixed_length:
            return self.fixed_length
        return len(self.audio_files)

    def _load(self, idx: int) -> np.ndarray:
        wav, sr = read_wav(self.audio_files[idx])
        if self.channels == 1 and wav.shape[0] > 1:
            wav = wav.mean(axis=0, keepdims=True)
        if sr != self.sample_rate:
            wav = resample(wav, sr, self.sample_rate)
        if wav.shape[0] == 1 and self.channels > 1:
            wav = np.repeat(wav, self.channels, axis=0)
        return wav.astype(np.float32)

    def __getitem__(self, idx: int) -> np.ndarray:
        """A random ``tensor_cut`` crop ``[C, tensor_cut]`` (the whole clip
        when it is not longer). An unreadable file is dropped and another
        index drawn, as in the JAX package."""
        while True:
            idx = idx % len(self.audio_files)
            try:
                wav = self._load(idx)
                break
            except Exception as exc:
                logger.warning('dropping unreadable file %s (%s)', self.audio_files[idx], exc)
                del self.audio_files[idx]
                if not self.audio_files:
                    raise RuntimeError('every file in the dataset failed to load') from exc
                idx = self.rng.randrange(len(self.audio_files))
        if self.tensor_cut > 0 and wav.shape[1] > self.tensor_cut:
            start = self._crop_rng(idx).randrange(0, wav.shape[1] - self.tensor_cut)
            wav = wav[:, start:start + self.tensor_cut]
        return wav

    def get(self):
        """(a random uncropped clip ``[C, T]``, the sample rate), for the
        reconstruction demo."""
        return self._load(self.rng.randrange(len(self))), self.sample_rate


def pad_collate(batch: Sequence[np.ndarray], length: Optional[int] = None) -> np.ndarray:
    """Zero-pad ``[C, T_i]`` clips into ``[B, C, length]`` (default: the
    longest), cropping longer clips from the start."""
    if length is None:
        length = max(x.shape[1] for x in batch)
    out = np.zeros((len(batch), batch[0].shape[0], length), np.float32)
    for i, x in enumerate(batch):
        t = min(x.shape[1], length)
        out[i, :, :t] = x[:, :t]
    return out


class DataLoader:
    """Fixed-length batches, shuffled by ``(seed, epoch)`` unless
    ``shuffle`` is False; the last partial batch is dropped. Under data
    parallelism each rank loads shard ``shard_id`` of ``num_shards``: the
    indices ``idx[shard_id::num_shards]`` after the shuffle, which every rank
    draws alike, so the shards are disjoint (the JAX package's loader, the
    reference's ``DistributedSampler``)."""

    def __init__(self, dataset: CustomAudioDataset, batch_size: int,
                 fixed_length: Optional[int] = None, seed: int = 0, shuffle: bool = True,
                 shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.fixed_length = fixed_length
        self.seed = seed
        self.shuffle = shuffle
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.dataset) // self.num_shards // self.batch_size

    def _indices(self) -> list:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_id::self.num_shards]

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = self._indices()
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield pad_collate([self.dataset[i] for i in chunk], self.fixed_length)
