"""Residual vector quantizer with the bandwidth → n_q policy.

Port of ``encodec_pytorch_tpu/quantization/vq.py``: ``bw_per_q = log2(bins) ·
frame_rate / 1000`` (0.75 kbps a codebook at 75 Hz and 1024 bins) and
``n_q = max(1, floor(bw / bw_per_q))``.
"""

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.mesh import DataParallel
from .core_vq import ResidualVectorQuantization, rvq_decode, rvq_encode, rvq_forward


class ResidualVectorQuantizer(nn.Module):
    """Holds the stages under ``vq`` (``quantizer.vq.layers...`` keys)."""

    def __init__(self, dimension: int = 256, n_q: int = 8, bins: int = 1024,
                 decay: float = 0.99, kmeans_iters: int = 50,
                 threshold_ema_dead_code: int = 2):
        super().__init__()
        self.dimension, self.n_q, self.bins = dimension, n_q, bins
        self.decay, self.kmeans_iters = decay, kmeans_iters
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.vq = ResidualVectorQuantization(n_q, dimension, bins)

    def bandwidth_per_quantizer(self, frame_rate: int) -> float:
        return math.log2(self.bins) * frame_rate / 1000

    def num_quantizers_for_bandwidth(self, frame_rate: int,
                                     bandwidth: Optional[float] = None) -> int:
        n_q = self.n_q
        if bandwidth and bandwidth > 0.:
            n_q = int(max(1, math.floor(bandwidth / self.bandwidth_per_quantizer(frame_rate))))
        return n_q

    def encode(self, x: torch.Tensor, frame_rate: int,
               bandwidth: Optional[float] = None) -> torch.Tensor:
        """``x [B, T, D]`` → codes ``[K, B, T]`` int32."""
        n_q = self.num_quantizers_for_bandwidth(frame_rate, bandwidth)
        embed, esq = self.vq.tables(n_q)
        return rvq_encode(embed, x, esq)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[K, B, T]`` → ``[B, T, D]``."""
        return rvq_decode(self.vq.tables(codes.shape[0])[0], codes)

    def forward_train(self, x: torch.Tensor, n_q: int,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
                      dp: Optional[DataParallel] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward over ``n_q`` stages of ``x [B, T, D]``: returns
        (quantized with the straight-through gradient, commitment loss). The
        codebook buffers are updated in place (EMA, k-means init, expiry);
        under ``dp`` from every rank's rows (``x`` is this rank's), alike on
        every rank.

        Which stages still need their k-means init is read from the buffers
        in one device-to-host copy, only for stages not yet seen inited
        (:meth:`~..core_vq.ResidualVectorQuantization.inited_flags`): once
        every stage a step uses has run its init, the forward does not sync."""
        states = self.vq.states()
        n = min(n_q, len(states))
        quantized, _, penalty, new_states = rvq_forward(
            states, x, n_q, decay=self.decay, kmeans_iters=self.kmeans_iters,
            threshold_ema_dead_code=self.threshold_ema_dead_code, generator=generator,
            draws=draws, inited=self.vq.inited_flags(n), dp=dp)
        self.vq.set_states(new_states)
        self.vq.mark_inited(n)
        return quantized, penalty
