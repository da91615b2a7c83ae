"""EnCodec model assembly: the eval path and the training forward.

Port of ``encodec_pytorch_tpu/models/model.py``.
``EncodecModel`` is an ``nn.Module`` that holds the encoder, the quantizer
and the decoder; its state dict has the released checkpoint's keys
(``encoder.model...``, ``decoder.model...``, ``quantizer.vq.layers...``).

Boundaries keep the JAX package's layout: wav ``[B, C, T]``, codes
``[B, K, T]``. A segmented model (the 48 kHz family: 1 s segments with a 1 %
overlap) encodes each segment to its own frame, with the segment's volume
scale when the model normalizes, and decodes by triangular overlap-add
(``utils.linear_overlap_add``). ``encode_segmajor`` and ``decode_segmajor``
fold the full segments into the batch axis, one call for all of them and one
for the ragged tail, as the JAX servers do by default.

``MODELS`` maps the CLI's model names to factories: the released
``encodec_24khz`` and ``encodec_48khz`` (released-layout ``.th``), and
``my_encodec`` and ``encodec_bw``, which load a trainer checkpoint
(:func:`trainer_state_dict`: the quantizer under ``quantizer.model``) into a
non-causal ``time_group_norm`` 24 kHz model, as the JAX package's factories
of those names do.

Every factory takes the SEANet's compute ``dtype`` (float32, the default, or
bfloat16: the JAX package's ``dtype`` at ``models/model.py:360-370``); the
parameters stay f32 and the quantizer runs in f32 either way.
"""

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.custom import no_grad
from ..quantization.vq import ResidualVectorQuantizer
from ..utils import check_checksum, linear_overlap_add
from .seanet import SEANetDecoder, SEANetEncoder

# (codes [B, K, T], scale [B, 1] or None)
EncodedFrame = Tuple[torch.Tensor, Optional[torch.Tensor]]


class EncodecModel(nn.Module):
    """SEANetEncoder + ResidualVectorQuantizer + SEANetDecoder on raw wav."""

    def __init__(self, encoder: SEANetEncoder, decoder: SEANetDecoder,
                 quantizer: ResidualVectorQuantizer, target_bandwidths: Sequence[float],
                 sample_rate: int, channels: int, normalize: bool = False,
                 segment: Optional[float] = None, overlap: float = 0.01,
                 name: str = 'unset'):
        super().__init__()
        self.segment = segment
        self.overlap = overlap
        self.normalize = normalize
        self.bandwidth: Optional[float] = None
        self.target_bandwidths = list(target_bandwidths)
        self.encoder = encoder
        self.quantizer = quantizer
        self.decoder = decoder
        self.sample_rate = sample_rate
        self.channels = channels
        self.frame_rate = math.ceil(sample_rate / np.prod(encoder.ratios))
        self.name = name
        self.bits_per_codebook = int(math.log2(quantizer.bins))
        if 2 ** self.bits_per_codebook != quantizer.bins:
            raise ValueError('quantizer bins must be a power of 2')

    @property
    def device(self) -> torch.device:
        return self.quantizer.vq.layers[0]._codebook.embed.device

    @property
    def segment_length(self) -> Optional[int]:
        return None if self.segment is None else int(self.segment * self.sample_rate)

    @property
    def segment_stride(self) -> Optional[int]:
        length = self.segment_length
        return None if length is None else max(1, int((1 - self.overlap) * length))

    def _segments(self, length: int) -> Tuple[int, int]:
        """(segment length, stride) for a clip of ``length`` samples: the
        whole clip when the model is not segmented."""
        if self.segment_length is None:
            return length, length
        return self.segment_length, self.segment_stride

    def set_target_bandwidth(self, bandwidth: float):
        if bandwidth not in self.target_bandwidths:
            raise ValueError(f"This model doesn't support the bandwidth {bandwidth}. "
                             f"Select one of {self.target_bandwidths}.")
        self.bandwidth = bandwidth

    @staticmethod
    def _check_wav(x: torch.Tensor) -> None:
        if x.dim() != 3 or not 0 < x.shape[1] <= 2:
            raise ValueError(f'expected wav [B, C, T] with 1 or 2 channels, got {tuple(x.shape)}')

    @no_grad
    def encode(self, x: torch.Tensor) -> List[EncodedFrame]:
        """``[B, C, T]`` wav → one frame ``(codes [B, K, T'], scale [B, 1] or
        None)`` a segment (one for an unsegmented model)."""
        self._check_wav(x)
        length = x.shape[-1]
        segment_length, stride = self._segments(length)
        return [self._encode_frame(x[:, :, offset:offset + segment_length])
                for offset in range(0, length, stride)]

    def _encode_frame(self, x: torch.Tensor) -> EncodedFrame:
        if self.segment is not None and x.shape[-1] / self.sample_rate > 1e-5 + self.segment:
            raise ValueError(f'a frame of {x.shape[-1]} samples is longer than a segment')
        x, scale = self._normalize_frame(x)
        emb = self.encoder(x)                                          # [B, D, T']
        codes = self.quantizer.encode(emb.transpose(1, 2), self.frame_rate,
                                      self.bandwidth)                  # [K, B, T']
        return codes.transpose(0, 1), scale

    @no_grad
    def decode(self, encoded_frames: List[EncodedFrame]) -> torch.Tensor:
        """Frames → ``[B, C, T]`` wav; segments are overlap-added."""
        if self.segment_length is None:
            if len(encoded_frames) != 1:
                raise ValueError('an unsegmented model decodes exactly one frame')
            return self._decode_frame(encoded_frames[0])
        return linear_overlap_add([self._decode_frame(f) for f in encoded_frames],
                                  self.segment_stride)

    @no_grad
    def encode_segmajor(self, x: torch.Tensor) -> List[EncodedFrame]:
        """:meth:`encode` with every full-length segment folded into the batch
        axis (``[B, C, T]`` → ``[B·S, C, L]``, one encoder call), and the
        ragged tail segments as calls of their own. Each segment sees the same
        arithmetic (normalization is per batch row); only the batch of the
        convs changes, so codes equal :meth:`encode`'s up to near-ties at
        f32."""
        self._check_wav(x)
        if self.segment_length is None:
            return self.encode(x)
        B, channels, length = x.shape
        L, stride = self.segment_length, self.segment_stride
        offsets = list(range(0, length, stride))
        full = [o for o in offsets if o + L <= length]
        frames: List[EncodedFrame] = []
        if full:
            S = len(full)
            windows = x.unfold(-1, L, stride)[:, :, :S]                  # [B, C, S, L]
            windows = windows.transpose(1, 2).reshape(B * S, channels, L)
            codes, scale = self._encode_frame(windows)
            codes = codes.reshape(B, S, *codes.shape[1:])               # [B, S, K, T']
            if scale is not None:
                scale = scale.reshape(B, S, 1)
            frames += [(codes[:, s], None if scale is None else scale[:, s])
                       for s in range(S)]
        frames += [self._encode_frame(x[:, :, o:o + L]) for o in offsets
                   if o + L > length]
        return frames

    @no_grad
    def decode_segmajor(self, encoded_frames: List[EncodedFrame]) -> torch.Tensor:
        """:meth:`decode` with every run of frames of one code length decoded
        in one batched call; frame order is kept for the overlap-add."""
        if self.segment_length is None:
            return self.decode(encoded_frames)
        groups: Dict[int, List[int]] = {}
        for i, (codes, _) in enumerate(encoded_frames):
            groups.setdefault(int(codes.shape[-1]), []).append(i)
        decoded: List[Optional[torch.Tensor]] = [None] * len(encoded_frames)
        for members in groups.values():
            codes = torch.cat([encoded_frames[i][0] for i in members])
            scales = [encoded_frames[i][1] for i in members]
            scale = None if scales[0] is None else torch.cat(scales)
            out = self._decode_frame((codes, scale))
            out = out.reshape(len(members), -1, *out.shape[1:])
            for j, i in enumerate(members):
                decoded[i] = out[j]
        return linear_overlap_add(decoded, self.segment_stride)

    def _decode_frame(self, encoded_frame: EncodedFrame) -> torch.Tensor:
        codes, scale = encoded_frame
        emb = self.quantizer.decode(codes.transpose(0, 1))             # [B, T', D]
        out = self.decoder(emb.transpose(1, 2))
        if scale is not None:
            out = out * scale.reshape(-1, 1, 1)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Encode then decode, cut to the input length."""
        return self.decode(self.encode(x))[:, :, :x.shape[-1]]

    def _normalize_frame(self, x: torch.Tensor):
        """Volume normalization of a segment: ``x / (1e-8 + rms of the mono
        mix)``; returns (x, scale [B, 1]) or (x, None) when the model does not
        normalize."""
        if not self.normalize:
            return x, None
        mono = torch.mean(x, dim=1, keepdim=True)
        scale = 1e-8 + torch.sqrt(torch.mean(torch.square(mono), dim=2, keepdim=True))
        return x / scale, scale.reshape(-1, 1)

    def n_q_for_bandwidth_index(self) -> List[int]:
        """n_q of each target bandwidth, in order."""
        return [self.quantizer.num_quantizers_for_bandwidth(self.frame_rate, bw)
                for bw in self.target_bandwidths]

    def forward_train(self, x: torch.Tensor, n_q: int,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Sequence] = None, dp=None):
        """Training forward of ``x [B, C, T]`` at ``n_q`` stages (the step
        draws it from the target bandwidths): for each segment (the whole clip
        when the model is not segmented) normalize, encode, quantize with the
        EMA update (codebook buffers change in place, segment after segment),
        decode and rescale; then overlap-add the segments and cut to T.
        ``draws`` (tests) holds the RVQ's draws of each segment in order: for
        an unsegmented model the per-stage list itself, for a segmented one a
        list of them. ``dp`` (a ``parallel.mesh.DataParallel``): ``x`` is this
        rank's rows of the global batch, and the quantizer's EMA update is the
        global batch's. Returns (output [B, C, T], commitment loss summed over
        the segments)."""
        length = x.shape[-1]
        segment_length, stride = self._segments(length)
        offsets = range(0, length, stride)
        if draws is not None and self.segment_length is None:
            draws = [draws]
        loss_w = x.new_zeros(())
        decoded = []
        for i, offset in enumerate(offsets):
            frame, scale = self._normalize_frame(x[:, :, offset:offset + segment_length])
            emb = self.encoder(frame)                                    # [B, D, T']
            quantized, penalty = self.quantizer.forward_train(
                emb.transpose(1, 2), n_q, generator, None if draws is None else draws[i], dp)
            out = self.decoder(quantized.transpose(1, 2))
            if scale is not None:
                out = out * scale.reshape(-1, 1, 1)
            decoded.append(out)
            loss_w = loss_w + penalty
        wav = decoded[0] if len(decoded) == 1 else linear_overlap_add(decoded, stride)
        return wav[:, :, :length], loss_w

    @staticmethod
    def _get_model(target_bandwidths: Sequence[float], sample_rate: int = 24_000,
                   channels: int = 1, causal: bool = True, model_norm: str = 'weight_norm',
                   audio_normalize: bool = False, segment: Optional[float] = None,
                   name: str = 'unset', ratios=(8, 5, 4, 2), n_q: Optional[int] = None,
                   n_filters: int = 32, pad_mode: str = 'reflect',
                   generator: Optional[torch.Generator] = None,
                   dtype: torch.dtype = torch.float32) -> 'EncodecModel':
        """Build the architecture on the CPU; ``n_q`` defaults to the
        reference's formula (32 at 24 kHz, 24 kbps). Weights are torch's
        default init drawn from ``generator`` (seed 0 when none is given);
        codebooks start at zeros, the untrained state. ``dtype`` is the
        SEANet's compute dtype (the parameters and the quantizer stay f32)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        encoder = SEANetEncoder(channels=channels, norm=model_norm, causal=causal,
                                ratios=tuple(ratios), n_filters=n_filters,
                                pad_mode=pad_mode, generator=generator, dtype=dtype)
        decoder = SEANetDecoder(channels=channels, norm=model_norm, causal=causal,
                                ratios=tuple(ratios), n_filters=n_filters,
                                pad_mode=pad_mode, generator=generator, dtype=dtype)
        if n_q is None:
            n_q = int(1000 * target_bandwidths[-1]
                      // (math.ceil(sample_rate / encoder.hop_length) * 10))
        quantizer = ResidualVectorQuantizer(dimension=encoder.dimension, n_q=n_q, bins=1024)
        return EncodecModel(encoder, decoder, quantizer, target_bandwidths, sample_rate,
                            channels, normalize=audio_normalize, segment=segment, name=name)


def encodec_model_24khz(checkpoint: Optional[Union[str, os.PathLike]] = None,
                        pretrained: bool = False, device: Union[str, torch.device] = 'cuda',
                        generator: Optional[torch.Generator] = None,
                        dtype: torch.dtype = torch.float32) -> EncodecModel:
    """The causal 24 kHz model, in eval mode on ``device``, with the weights of
    ``checkpoint`` (a released-layout ``.th``) when one is given."""
    model = EncodecModel._get_model(
        [1.5, 3., 6, 12., 24.], 24_000, 1, causal=True, model_norm='weight_norm',
        audio_normalize=False,
        name='encodec_24khz' if (pretrained or checkpoint) else 'unset',
        generator=generator, dtype=dtype)
    if checkpoint:
        load_checkpoint(model, checkpoint)
    return model.to(device).eval()


def encodec_model_48khz(checkpoint: Optional[Union[str, os.PathLike]] = None,
                        pretrained: bool = False, device: Union[str, torch.device] = 'cuda',
                        generator: Optional[torch.Generator] = None,
                        dtype: torch.dtype = torch.float32) -> EncodecModel:
    """The non-causal, normalized, stereo 48 kHz model with 1 s segments
    (``time_group_norm``), in eval mode on ``device``, with the weights of
    ``checkpoint`` (a released-layout ``.th``) when one is given."""
    model = EncodecModel._get_model(
        [3., 6., 12., 24.], 48_000, 2, causal=False, model_norm='time_group_norm',
        audio_normalize=True, segment=1.,
        name='encodec_48khz' if (pretrained or checkpoint) else 'unset',
        generator=generator, dtype=dtype)
    if checkpoint:
        load_checkpoint(model, checkpoint)
    return model.to(device).eval()


def my_encodec_model(checkpoint: Union[str, os.PathLike], ratios=(8, 5, 4, 2),
                     device: Union[str, torch.device] = 'cuda',
                     dtype: torch.dtype = torch.float32) -> EncodecModel:
    """A model trained by the trainer (``my_encodec``): 24 kHz mono,
    non-causal, ``time_group_norm``, normalized, unsegmented, with the
    weights of ``checkpoint`` (the trainer's layout, see
    :func:`trainer_state_dict`), in eval mode on ``device``. ``n_q`` is the
    number of RVQ stages in the file."""
    state = trainer_state_dict(checkpoint)
    model = EncodecModel._get_model(
        [1.5, 3., 6, 12., 24.], 24_000, 1, causal=False, model_norm='time_group_norm',
        audio_normalize=True, segment=None, name='my_encodec', ratios=ratios,
        n_q=checkpoint_n_q(state), dtype=dtype)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def encodec_model_bw(checkpoint: Union[str, os.PathLike],
                     bandwidth: Union[float, Sequence[float]] = 24.,
                     device: Union[str, torch.device] = 'cuda',
                     dtype: torch.dtype = torch.float32) -> EncodecModel:
    """A trained model with its own target bandwidths (one, or a list) and
    1 s segments; otherwise as :func:`my_encodec_model`, with the default
    ``n_q`` of the largest bandwidth."""
    bandwidths = list(bandwidth) if isinstance(bandwidth, (list, tuple)) else [bandwidth]
    model = EncodecModel._get_model(
        bandwidths, 24_000, 1, causal=False, model_norm='time_group_norm',
        audio_normalize=True, segment=1., name='my_encodec', dtype=dtype)
    model.load_state_dict(trainer_state_dict(checkpoint), strict=True)
    return model.to(device).eval()


MODELS = {
    'encodec_24khz': encodec_model_24khz,
    'encodec_48khz': encodec_model_48khz,
    'my_encodec': my_encodec_model,
    'encodec_bw': encodec_model_bw,
}


def load_checkpoint(model: EncodecModel, path: Union[str, os.PathLike]) -> None:
    """Load a released-layout torch state dict into ``model``, strictly.

    A released file carries a sha256 prefix in its name
    (``encodec_24khz-d7cc33bc.th``), which is checked first.
    """
    stem = os.path.splitext(os.path.basename(str(path)))[0]
    if '-' in stem:
        check_checksum(path, stem.split('-')[1])
    state = torch.load(path, map_location='cpu', weights_only=True)
    model.load_state_dict(state, strict=True)


def to_trainer_layout(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A model state dict in the reference trainer's layout: the quantizer
    under ``quantizer.model`` instead of ``quantizer.vq``."""
    return {_rename_prefix(k, 'quantizer.vq.', 'quantizer.model.'): v for k, v in state.items()}


def from_trainer_layout(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`to_trainer_layout`."""
    return {_rename_prefix(k, 'quantizer.model.', 'quantizer.vq.'): v for k, v in state.items()}


def _rename_prefix(key: str, old: str, new: str) -> str:
    return new + key[len(old):] if key.startswith(old) else key


def trainer_state_dict(path: Union[str, os.PathLike]) -> Dict[str, torch.Tensor]:
    """The generator's state dict from a trainer checkpoint
    (``{'model_state_dict': ...}`` in the trainer layout, as the reference
    trainer and this package's trainer write it) or from a flat state dict."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    return from_trainer_layout(obj.get('model_state_dict', obj))


def checkpoint_n_q(state: Dict[str, torch.Tensor]) -> Optional[int]:
    """The number of RVQ stages in a state dict (None when it has none)."""
    stages = {int(k.split('.layers.')[1].split('.')[0]) for k in state if '.layers.' in k}
    return max(stages) + 1 if stages else None
