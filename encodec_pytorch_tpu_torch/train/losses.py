"""Generator and discriminator losses.

Port of ``encodec_pytorch_tpu/train/losses.py``. The balancer weights
(λ_t 0.1, λ_f 1, λ_g 3, λ_feat 3) live in the config; these functions return
the raw losses. Kept from the reference, as the JAX package keeps them:
``l_g`` is divided by K twice, and ``l_f`` sums L1 + L2 over seven log-mel
scales (window 2^i, hop 2^i/4, i = 5..11, 64 mel bins).

Every loss is a mean over the batch, so under data parallelism the global
loss is the mean of the ranks' losses, but for ``l_feat``: each of its terms
is a ratio of two means, ``mean|real - fake| / mean|real|``, and its
denominator is taken over the global batch (``dp``).
"""

from typing import Dict, List, Optional, Sequence

import torch

from ..ops.stft import audio_to_mel
from ..parallel.mesh import DataParallel

MEL_SCALES: Sequence[int] = tuple(range(5, 12))


def spectral_reconstruction_loss(input_wav: torch.Tensor, output_wav: torch.Tensor,
                                 sample_rate: int = 24000) -> torch.Tensor:
    """l_f: multi-scale log-mel L1 + L2."""
    l_f = input_wav.new_zeros(())
    for i in MEL_SCALES:
        kwargs = dict(n_fft=2 ** i, win_length=2 ** i, hop_length=(2 ** i) // 4,
                      sampling_rate=sample_rate, n_mel_channels=64)
        diff = audio_to_mel(input_wav, **kwargs) - audio_to_mel(output_wav, **kwargs)
        l_f = l_f + torch.mean(torch.abs(diff)) + torch.mean(torch.square(diff))
    return l_f


def wav_losses(input_wav: torch.Tensor, output_wav: torch.Tensor,
               sample_rate: int = 24000) -> Dict[str, torch.Tensor]:
    """The losses whose gradient flows from the waveforms: {l_t, l_f}."""
    return {'l_t': torch.mean(torch.abs(input_wav - output_wav)),
            'l_f': spectral_reconstruction_loss(input_wav, output_wav, sample_rate)}


def gan_losses(fmap_real: List[List[torch.Tensor]], logits_fake: List[torch.Tensor],
               fmap_fake: List[List[torch.Tensor]],
               dp: Optional[DataParallel] = None) -> Dict[str, torch.Tensor]:
    """The losses whose gradient flows through the discriminator:
    {l_g, l_feat}. Under ``dp`` the batch is this rank's rows, and ``l_feat``'s
    denominators, the real feature maps' mean magnitudes, are the global
    batch's (one all-reduce)."""
    l_g = logits_fake[0].new_zeros(())
    l_feat = logits_fake[0].new_zeros(())
    K = len(fmap_real)
    scale = torch.stack([torch.mean(torch.abs(real)) for fm in fmap_real for real in fm])
    if dp is not None:
        scale = dp.sum_(scale) / dp.world
    scales = iter(scale)
    for k in range(K):
        l_g = l_g + torch.mean(torch.relu(1 - logits_fake[k])) / len(logits_fake)
        for real, fake in zip(fmap_real[k], fmap_fake[k]):
            l_feat = l_feat + torch.mean(torch.abs(real - fake)) / next(scales)
    return {'l_g': l_g / K, 'l_feat': l_feat / (K * len(fmap_real[0]))}


def disc_loss(logits_real: List[torch.Tensor], logits_fake: List[torch.Tensor]) -> torch.Tensor:
    """Hinge discriminator loss."""
    lossd = logits_real[0].new_zeros(())
    for real, fake in zip(logits_real, logits_fake):
        lossd = lossd + torch.mean(torch.relu(1 - real)) + torch.mean(torch.relu(1 + fake))
    return lossd / len(logits_real)
