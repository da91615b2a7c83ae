"""Host-side data pipeline: wav IO, the CSV and multi-channel scene datasets,
the batch loader, and the dataset prep CLI (``python -m
encodec_pytorch_tpu_torch.data.prep``)."""

from .audio_io import read_wav, resample, wav_info, write_wav  # noqa: F401
from .dataset import CustomAudioDataset, DataLoader, pad_collate  # noqa: F401
from .multi_channel import MultiChannelAudioDataset  # noqa: F401
