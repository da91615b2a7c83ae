"""Multi-channel (ambisonic) scene dataset: one random channel and a random
1-second window of a scene file a sample, and 100 fixed validation segments.

Port of ``encodec_pytorch_tpu/data/multi_channel.py``, draw for draw: the
same folders and sorted file list, the same ``(seed, epoch, index)``-keyed
``random.Random`` draws (salt 0 for the channel and the window, salt 1 for the
crop), the same ranged reads and scipy resample, so that both packages give
the same items bit for bit. A file that fails to load is skipped for another
random index, as in the JAX package, but only ``MAX_RETRIES`` times in a row:
the JAX set retries without end, which on a tree it cannot read recurses until
Python's recursion limit.
"""

import glob
import logging
import random
from pathlib import Path
from typing import Optional

import numpy as np

from .audio_io import read_wav, resample, wav_info

logger = logging.getLogger(__name__)

TRAIN_FOLDERS = ['Beach', 'Busy Street', 'Park', 'Pedestrian Zone',
                 'Quiet Street', 'Shopping Centre']
TEST_FOLDERS = ['Woodland', 'Train Station']
AUDIO_EXTENSIONS = ['*.wav', '*.flac', '*.mp3', '*.m4a']
MAX_RETRIES = 10


class MultiChannelAudioDataset:
    """Scene files under ``datasets.data_root``'s train or test folders.

    ``config`` needs ``datasets.{data_root, tensor_cut, fixed_length}`` and
    ``model.sample_rate``. ``__len__`` is ``fixed_length`` when it
    is set, else the number of files; items are ``[1, T]`` float32 (1 s at
    ``model.sample_rate``, cropped to ``tensor_cut``).
    """

    def __init__(self, config, mode: str = 'train', seed: Optional[int] = None):
        if mode not in ('train', 'test'):
            raise ValueError(f"dataset mode must be 'train' or 'test', got {mode!r}")
        self.data_root = config.datasets.data_root
        self.sample_rate = int(config.model.sample_rate)
        self.tensor_cut = int(config.datasets.tensor_cut or 0)
        self.fixed_length = int(config.datasets.fixed_length or 0)
        self.mode = mode
        self.seed = None if seed is None else int(seed)
        self.epoch = 0
        self.folders = TRAIN_FOLDERS if mode == 'train' else TEST_FOLDERS

        self.audio_files = []
        for folder in self.folders:
            folder_path = Path(self.data_root) / folder
            if folder_path.exists():
                for ext in AUDIO_EXTENSIONS:
                    self.audio_files.extend(glob.glob(str(folder_path / ext)))
            else:
                logger.warning('Folder %s does not exist', folder_path)
        if not self.audio_files:
            raise ValueError(f'No audio files found in folders: {self.folders}')
        self.audio_files.sort()

        if mode == 'test':
            self.fixed_segments = self._create_fixed_validation_segments()
        logger.info('Found %d audio files for %s mode', len(self.audio_files), mode)

    def __len__(self):
        return self.fixed_length if self.fixed_length > 0 else len(self.audio_files)

    def _create_fixed_validation_segments(self):
        """One segment a file, for at most 100 files: file i, channel
        ``i mod min(32, C)``, start ``(i·0.1 s) mod max_start``."""
        fixed = []
        for i in range(min(100, len(self.audio_files))):
            audio_path = self.audio_files[i % len(self.audio_files)]
            sr, n_frames, n_channels = wav_info(audio_path)
            file_duration = n_frames / sr
            channel_idx = i % min(32, n_channels)
            max_start_time = max(0, file_duration - 1.0)
            start_time = (i * 0.1) % max_start_time if max_start_time > 0 else 0.0
            fixed.append(dict(audio_path=audio_path, channel_idx=channel_idx,
                              start_time=start_time, sample_rate=sr))
        return fixed

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _draw_rng(self, idx: int, salt: int = 0):
        """The ``(seed, epoch, idx)``-keyed generator when seeded, else the
        module's ``random`` stream; ``salt`` separates the window draw (0)
        from the crop draw (1)."""
        if self.seed is None:
            return random
        return random.Random(
            ((self.seed * 1_000_003 + self.epoch) * 1_000_003 + idx) * 7 + salt)

    def _segment(self, idx: int) -> np.ndarray:
        if self.mode == 'test':
            seg = self.fixed_segments[idx % len(self.fixed_segments)]
            audio_path, channel_idx = seg['audio_path'], seg['channel_idx']
            start_time, sample_rate = seg['start_time'], seg['sample_rate']
        else:
            rng = self._draw_rng(idx)
            audio_path = self.audio_files[idx % len(self.audio_files)]
            sample_rate, n_frames, n_channels = wav_info(audio_path)
            channel_idx = rng.randint(0, min(31, n_channels - 1))
            start_time = rng.uniform(0, max(0, n_frames / sample_rate - 1.0))
        wav, sample_rate = read_wav(audio_path, start=int(start_time * sample_rate),
                                    frames=int(1.0 * sample_rate))
        audio = wav[min(channel_idx, wav.shape[0] - 1)]
        target_length = int(1.0 * self.sample_rate)
        if sample_rate != self.sample_rate:
            audio = resample(audio, sample_rate, self.sample_rate)
        if len(audio) < target_length:
            audio = np.concatenate([audio, np.zeros(target_length - len(audio), np.float32)])
        elif len(audio) > target_length:
            audio = audio[:target_length]
        return audio[None, :].astype(np.float32)

    def get(self, idx: Optional[int] = None):
        """(an uncropped 1-second mono segment ``[1, sample_rate]``, the
        sample rate): item ``idx``, or a random one."""
        if idx is not None and idx >= len(self):
            raise IndexError(idx)
        if idx is None:
            idx = random.randrange(len(self))
        for attempt in range(MAX_RETRIES + 1):
            try:
                return self._segment(idx), self.sample_rate
            except Exception as exc:     # an unreadable file: another random item
                logger.warning('Error loading audio: %s', exc)
                if attempt == MAX_RETRIES:
                    raise RuntimeError(f'{MAX_RETRIES + 1} scene items in a row failed '
                                       f'to load') from exc
                idx = random.randint(0, len(self) - 1)

    def __getitem__(self, idx: int) -> np.ndarray:
        waveform, _ = self.get(idx)
        if self.tensor_cut > 0 and waveform.shape[1] > self.tensor_cut:
            start = self._draw_rng(idx, salt=1).randint(
                0, waveform.shape[1] - self.tensor_cut - 1)
            waveform = waveform[:, start:start + self.tensor_cut]
        return waveform
