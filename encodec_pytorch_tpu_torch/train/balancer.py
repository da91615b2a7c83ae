"""Gradient-norm loss balancer.

Port of ``encodec_pytorch_tpu/train/balancer.py`` with the settings the
trainer uses (its defaults). Given each loss's gradient with respect to the
generator output, it rescales them so that loss ``k`` contributes
``weights[k] / Σ weights`` of a unit total norm, using an EMA (decay 0.999)
of each gradient's norm (mean over batch items of the per-item L2 norm), and
sums them into one cotangent for ``output.backward``. The EMA state
(``total``, ``fix``: one scalar tensor per loss) lives on the balancer and is
updated in place by each call.

Under data parallelism (``dp``) each rank passes the gradients of its rows of
the global batch (the global loss's gradient, restricted to those rows): the
norm is the mean over the global batch of the per-item norms (the per-rank
sums are summed in one all-reduce) and the EMA counts the global batch, as the
JAX balancer does on its global batch under GSPMD. Every rank ends with the
same state, equal to a one-process call on the global batch.
"""

from typing import Dict, Optional, Tuple

import torch

from ..parallel.mesh import DataParallel


EMA_DECAY = 0.999
EPSILON = 1e-12


class Balancer:
    def __init__(self, weights: Dict[str, float]):
        self.weights = dict(weights)
        self.total: Dict[str, torch.Tensor] = {}
        self.fix: Dict[str, torch.Tensor] = {}

    def __call__(self, grads: Dict[str, torch.Tensor],
                 dp: Optional[DataParallel] = None) -> Tuple[torch.Tensor, Dict]:
        """``grads``: {name: dL_name/d_output}, output ``[B, ...]`` (under
        ``dp``, this rank's rows). Returns the combined cotangent (its rows)
        and the per-loss averaged norms."""
        names = sorted(grads)
        sums = torch.stack([torch.sum(torch.sqrt(torch.sum(
            torch.square(g), dim=tuple(range(1, g.dim()))))) for g in map(grads.get, names)])
        count = grads[names[0]].shape[0]
        if dp is not None:
            dp.sum_(sums)
            count *= dp.world
        norms = dict(zip(names, sums / count))
        beta = EMA_DECAY
        avg = {}
        for k in names:
            zero = norms[k].new_zeros(())
            self.total[k] = self.total.get(k, zero) * beta + count * norms[k]
            self.fix[k] = self.fix.get(k, zero) * beta + count
            avg[k] = self.total[k] / self.fix[k]
        total_weights = sum(self.weights[k] for k in names)
        out_grad = torch.zeros_like(grads[names[0]])
        for name in names:
            scale = (self.weights[name] / total_weights) / (EPSILON + avg[name])
            out_grad = out_grad + scale * grads[name]
        return out_grad, avg
