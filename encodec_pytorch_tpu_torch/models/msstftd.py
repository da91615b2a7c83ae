"""Multi-scale STFT discriminator.

Port of ``encodec_pytorch_tpu/models/msstftd.py`` in torch's NCHW layout with
H = STFT frames (time) and W = frequency bins: each scale takes the
normalized complex STFT (center=False) of the wav, stacks real and
imaginary parts as channels, and runs conv_0 (3x9) → conv_1..3 (3x9,
F-stride 2, T-dilation 1, 2, 4) → conv_4 (3x3) → conv_post (3x3,
``out_channels``), with LeakyReLU(0.2) after each but the last. conv_1..conv_4
of each scale are the convs kernel K4 takes (12 launches per discriminator
call at three scales) when ``disc_kernel`` is on; with ``disc_im2col`` on too,
the forward of conv_1..conv_3 is kernel K5's (9 launches a call) and their
input gradient stays K4's.

In bfloat16 (``dtype``) the STFT and the spectrogram stay f32, as the JAX
module's do; each conv casts its input and weight to bf16 (K4 and K5 in their
bf16 forms), the activations between convs are bf16, and the logits and the
feature maps are cast to f32 before the losses
(``encodec_pytorch_tpu/models/msstftd.py:113-117``).

State-dict keys are the reference torch layout that
``encodec_pytorch_tpu/export.py`` ``msstftd_state_dict`` writes:
``discriminators.{i}.convs.{j}.conv.*``, ``discriminators.{i}.conv_post.conv.*``
and the hann window ``discriminators.{i}.spec_transform.window``.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import NormConv2d
from ..ops.stft import hann_window, stft


def get_2d_padding(kernel_size: Tuple[int, int],
                   dilation: Tuple[int, int] = (1, 1)) -> Tuple[int, int]:
    return (((kernel_size[0] - 1) * dilation[0]) // 2,
            ((kernel_size[1] - 1) * dilation[1]) // 2)


class _Spectrogram(nn.Module):
    """Holds the window buffer under torchaudio's key name."""

    def __init__(self, win_length: int):
        super().__init__()
        self.register_buffer('window', torch.from_numpy(hann_window(win_length)))


# The reference's fixed architecture (the JAX module's defaults, which no
# config changes): weight norm after conv_0, and filters_scale 1 keeps every
# conv at `filters` channels.
KERNEL = (3, 9)
DILATIONS = (1, 2, 4)
STRIDE = (1, 2)
SLOPE = 0.2


class DiscriminatorSTFT(nn.Module):
    """``forward(x [B, C, T]) → (logits [B, 1, T', F'], 5 fmaps [B, filters, T', F_i])``."""

    def __init__(self, filters: int, in_channels: int = 1, out_channels: int = 1,
                 n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                 disc_kernel: bool = False, disc_im2col: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.spec_transform = _Spectrogram(win_length)
        conv = dict(disc_kernel=disc_kernel, generator=generator, dtype=dtype)
        convs = [NormConv2d(2 * in_channels, filters, KERNEL, padding=get_2d_padding(KERNEL),
                            norm='none', **conv)]
        for dilation in DILATIONS:
            convs.append(NormConv2d(filters, filters, KERNEL, stride=STRIDE,
                                    dilation=(dilation, 1),
                                    padding=get_2d_padding(KERNEL, (dilation, 1)),
                                    norm='weight_norm', disc_im2col=disc_im2col, **conv))
        ks = (KERNEL[0], KERNEL[0])
        convs.append(NormConv2d(filters, filters, ks, padding=get_2d_padding(ks),
                                norm='weight_norm', **conv))
        self.convs = nn.ModuleList(convs)
        self.conv_post = NormConv2d(filters, out_channels, ks, padding=get_2d_padding(ks),
                                    norm='weight_norm', generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor):
        spec = stft(x, self.n_fft, self.hop_length, self.win_length,
                    window=self.spec_transform.window, normalized=True)   # [B, C, F, T']
        z = torch.cat([spec.real, spec.imag], dim=1).transpose(2, 3)       # [B, 2C, T', F]
        fmap: List[torch.Tensor] = []
        for layer in self.convs:
            z = F.leaky_relu(layer(z), SLOPE)
            fmap.append(z.float())
        return self.conv_post(z).float(), fmap


class MultiScaleSTFTDiscriminator(nn.Module):
    """``forward(x [B, C, T]) → (logits: list, fmaps: list of 5-lists)``, one
    entry per scale."""

    def __init__(self, filters: int, in_channels: int = 1, out_channels: int = 1,
                 n_ffts: Sequence[int] = (1024, 2048, 512),
                 hop_lengths: Sequence[int] = (256, 512, 128),
                 win_lengths: Sequence[int] = (1024, 2048, 512),
                 disc_kernel: bool = False, disc_im2col: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not len(n_ffts) == len(hop_lengths) == len(win_lengths):
            raise ValueError('n_ffts, hop_lengths and win_lengths must have one entry a scale')
        self.discriminators = nn.ModuleList(
            DiscriminatorSTFT(filters, in_channels, out_channels, n_fft=n_fft,
                              hop_length=hop, win_length=win,
                              disc_kernel=disc_kernel, disc_im2col=disc_im2col,
                              generator=generator, dtype=dtype)
            for n_fft, hop, win in zip(n_ffts, hop_lengths, win_lengths))

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        for disc in self.discriminators:
            logit, fmap = disc(x)
            logits.append(logit)
            fmaps.append(fmap)
        return logits, fmaps
