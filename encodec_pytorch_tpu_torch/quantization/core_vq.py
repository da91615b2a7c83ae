"""Residual vector quantization: eval search and the training forward.

Port of ``encodec_pytorch_tpu/quantization/core_vq.py``. The codebooks live in
modules laid out as the reference torch checkpoint
(``vq.layers.{k}._codebook.{inited,cluster_size,embed,embed_avg}`` buffers),
so a released ``.th`` loads with ``strict=True``.

:func:`rvq_encode` reaches kernel K1 on CUDA; :func:`rvq_decode` is a plain
gather-and-sum. Both read the stacked codebooks (and K1 their squared norms)
from :meth:`ResidualVectorQuantization.tables`, cached until a codebook
changes. The training side (:func:`rvq_forward`) is plain PyTorch, as
the JAX package's is plain XLA: per stage, k-means init on the first batch,
nearest code (``argmax 2·x·Eᵀ − ‖E‖²``), EMA update (decay 0.99, Laplace
ε 1e-5), dead-code expiry that really replaces dead codes (the reference's
is a no-op; the JAX package made it effective), the straight-through
estimator, and the commitment loss with the reference's direction bug kept
(``mse(stop_grad(q), residual)``). Stages at or past ``n_q`` are skipped and
keep their state, as the JAX package's masked scan leaves them.

Random draws (k-means seeds, expiry replacements) come from an explicit
``torch.Generator``; tests hand in the JAX package's index draws instead.

Data parallelism (``dp``, a :class:`~..parallel.mesh.DataParallel`): each rank
holds its rows of the global batch, and the training forward computes what the
JAX package's SPMD forward computes on the whole global batch, where XLA makes
the EMA statistics global sums (which fixes the reference's codebook broadcast,
"FIXME not working"). The per-cluster counts and sums of the EMA update and of
every k-means iteration are summed over the ranks before they are used; the
k-means seeds and the expiry rows are drawn over the global row count with the
same draw on every rank, and each rank fills the drawn rows it owns into a
zero ``[bins, D]`` buffer that is summed (no rank gathers the residual). The
nearest-code search stays local. Every rank ends with the same buffers.
"""

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import custom, rvq_kernel
from ..parallel.mesh import DataParallel


class EuclideanCodebook(nn.Module):
    """One stage's codebook buffers (``embed [bins, dim]`` and its EMA state),
    zeros until loaded: the state the reference's k-means init starts from."""

    def __init__(self, dim: int, bins: int):
        super().__init__()
        self.register_buffer('inited', torch.zeros(1))
        self.register_buffer('cluster_size', torch.zeros(bins))
        self.register_buffer('embed', torch.zeros(bins, dim))
        self.register_buffer('embed_avg', torch.zeros(bins, dim))


class VectorQuantization(nn.Module):
    """A stage: holds ``_codebook`` (the reference's projections are
    identities at codebook dim == dim and hold no parameters)."""

    def __init__(self, dim: int, bins: int):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, bins)


class ResidualVectorQuantization(nn.Module):
    """``layers``: the RVQ stages in order."""

    def __init__(self, n_q: int, dim: int, bins: int):
        super().__init__()
        self.layers = nn.ModuleList(VectorQuantization(dim, bins) for _ in range(n_q))
        self._tables: Dict[int, tuple] = {}
        self._inited_seen: Dict[int, Tuple[int, int]] = {}

    def embeds(self, n_q: int) -> torch.Tensor:
        """The first ``n_q`` codebooks stacked, ``[n_q, bins, dim]``."""
        return torch.stack([layer._codebook.embed for layer in self.layers[:n_q]])

    def tables(self, n_q: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """What the eval search reads: the first ``n_q`` codebooks stacked,
        ``[n_q, bins, dim]``, and their squared norms ``[n_q, bins]``. Cached
        per ``n_q`` until a codebook is replaced, moved or changed in place
        (an EMA update, :meth:`set_states`, ``load_state_dict``); treat them
        as read-only. While the model is traced (fake tensors have no
        storage to key on) they are computed in the traced program instead."""
        bufs = [layer._codebook.embed for layer in self.layers[:n_q]]
        if custom.tracing():
            embed = torch.stack(bufs)
            return embed, rvq_kernel.codebook_sq_norms(embed)
        key = tuple((b.data_ptr(), b._version) for b in bufs)
        hit = self._tables.get(n_q)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                embed = torch.stack(bufs)
                hit = (key, (embed, rvq_kernel.codebook_sq_norms(embed)))
            self._tables[n_q] = hit
        return hit[1]

    def _inited_key(self, k: int) -> Tuple[int, int]:
        buf = self.layers[k]._codebook.inited
        return buf.data_ptr(), buf._version

    def known_inited(self, k: int) -> bool:
        """Whether stage k is known, without reading the device, to have run
        its k-means init: it was seen inited and its ``inited`` buffer has not
        been replaced or written since."""
        return self._inited_seen.get(k) == self._inited_key(k)

    def inited_flags(self, n_q: int) -> List[bool]:
        """Which of the first ``n_q`` stages have run their k-means init. The
        stages not :meth:`known_inited` are read from the device in one copy
        (a host sync); once every stage a step uses is known, reading the
        flags costs none."""
        unknown = [k for k in range(n_q) if not self.known_inited(k)]
        if unknown:
            values = torch.cat([self.layers[k]._codebook.inited for k in unknown]).cpu()
            for k, v in zip(unknown, values.tolist()):
                if v:
                    self._inited_seen[k] = self._inited_key(k)
        return [self.known_inited(k) for k in range(n_q)]

    def mark_inited(self, n_q: int) -> None:
        """Record that the first ``n_q`` stages are inited as their buffers
        stand (after a training forward over them)."""
        for k in range(n_q):
            self._inited_seen[k] = self._inited_key(k)

    def states(self) -> List['StageState']:
        return [StageState(l._codebook.inited, l._codebook.cluster_size, l._codebook.embed,
                           l._codebook.embed_avg) for l in self.layers]

    @torch.no_grad()
    def set_states(self, states: Sequence['StageState']) -> None:
        """Write new stage states into the buffers, in place."""
        for layer, st in zip(self.layers, states):
            cb = layer._codebook
            for buf, new in zip((cb.inited, cb.cluster_size, cb.embed, cb.embed_avg), st):
                if new is not buf:
                    buf.copy_(new)


def rvq_encode(embed: torch.Tensor, x: torch.Tensor,
               esq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy residual nearest-code search over every stage of ``embed``.

    ``embed [K, N, D]``, ``x [B, T, D]`` (any strides) → codes ``[K, B, T]``
    int32. ``esq``: the codebooks' squared norms, when the caller caches them
    (:meth:`ResidualVectorQuantization.tables`). While tracing, the
    ``encodec::rvq_encode`` operator (``ops/custom.py``).
    """
    if custom.tracing():
        return torch.ops.encodec.rvq_encode(
            x, embed, rvq_kernel.codebook_sq_norms(embed) if esq is None else esq)
    return rvq_kernel.rvq_encode(x, embed.contiguous(), esq)


def rvq_decode(embed: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``codes [K, B, T]`` → ``[B, T, D]``: the sum of the chosen rows, stage
    by stage from zero."""
    K, B, T = codes.shape
    acc = torch.zeros(B, T, embed.shape[-1], dtype=embed.dtype, device=embed.device)
    for k in range(K):
        acc = acc + embed[k][codes[k].long()]
    return acc


# ------------------------------------------------------------------ training

LAPLACE_EPS = 1e-5


class StageState(NamedTuple):
    """One stage's EMA state: ``inited [1]``, ``cluster_size [N]``,
    ``embed [N, D]``, ``embed_avg [N, D]``."""
    inited: torch.Tensor
    cluster_size: torch.Tensor
    embed: torch.Tensor
    embed_avg: torch.Tensor


def nearest(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Index of the nearest row of ``embed [N, D]`` for each row of ``x [M, D]``."""
    scores = 2.0 * torch.matmul(x, embed.t()) - torch.sum(torch.square(embed), -1)[None, :]
    return torch.argmax(scores, dim=-1)


def sample_indices(m: int, num: int, generator: Optional[torch.Generator],
                   device: torch.device) -> torch.Tensor:
    """Rows to sample: a random permutation's prefix when ``m >= num``, draws
    with replacement otherwise (the JAX package's ``_sample_vectors``)."""
    gdev = generator.device if generator is not None else torch.device('cpu')
    if m >= num:
        idx = torch.randperm(m, generator=generator, device=gdev)[:num]
    else:
        idx = torch.randint(m, (num,), generator=generator, device=gdev)
    return idx.to(device)


def sample_vectors(samples: torch.Tensor, num: int, generator: Optional[torch.Generator] = None,
                   idx: Optional[torch.Tensor] = None,
                   dp: Optional[DataParallel] = None) -> torch.Tensor:
    """``num`` rows of ``samples [M, D]`` (under ``dp``, of the global
    ``[world·M, D]``): at ``idx``, or drawn from ``generator``."""
    if idx is None:
        m = samples.shape[0] * (dp.world if dp is not None else 1)
        idx = sample_indices(m, num, generator, samples.device)
    if dp is not None:
        return dp.gather_rows(samples, idx)
    return samples[idx.to(samples.device).long()]


def cluster_stats(onehot: torch.Tensor, x: torch.Tensor,
                  dp: Optional[DataParallel] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts ``[C]``, sums ``[C, D]``) of the rows of ``x [M, D]`` in each of
    ``onehot [M, C]``'s clusters; under ``dp`` over every rank's rows, summed
    in one all-reduce."""
    counts, sums = onehot.sum(0), torch.matmul(onehot.t(), x)
    if dp is None:
        return counts, sums
    both = dp.sum_(torch.cat([sums, counts[:, None]], 1))
    return both[:, -1], both[:, :-1]


def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int,
           generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None,
           dp: Optional[DataParallel] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-means by matmul distances; clusters left empty keep their mean.
    Returns (means [C, D], final cluster counts [C]). Under ``dp`` it runs
    over the global rows, ``samples`` being this rank's."""
    means = sample_vectors(samples, num_clusters, generator, idx, dp)
    for _ in range(num_iters):
        onehot = F.one_hot(nearest(samples, means), num_clusters).to(samples.dtype)
        bins, sums = cluster_stats(onehot, samples, dp)
        new_means = sums / torch.where(bins == 0, torch.ones_like(bins), bins)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    bins = F.one_hot(nearest(samples, means), num_clusters).to(samples.dtype).sum(0)
    return means, bins if dp is None else dp.sum_(bins)


@torch.no_grad()
def stage_train_forward(state: StageState, x: torch.Tensor, *, decay: float = 0.99,
                        threshold: int = 2, kmeans_iters: int = 50,
                        generator: Optional[torch.Generator] = None,
                        init_idx: Optional[torch.Tensor] = None,
                        expire_idx: Optional[torch.Tensor] = None,
                        inited: Optional[bool] = None,
                        dp: Optional[DataParallel] = None):
    """One stage on ``x [M, D]`` (no gradient flows through here). Under
    ``dp``, ``x`` is this rank's rows of the global residual, and
    ``init_idx`` and ``expire_idx`` index the global rows.

    Returns (quantized [M, D] before the straight-through estimator,
    codes [M], new state). ``inited`` is the host's reading of
    ``state.inited`` (read here when not given).
    """
    x = x.detach()
    cluster_size, embed, embed_avg, inited_t = (state.cluster_size, state.embed,
                                                state.embed_avg, state.inited)
    if inited is None:
        inited = bool(state.inited.item())
    if not inited:
        means, counts = kmeans(x, embed.shape[0], kmeans_iters, generator, init_idx, dp)
        embed, embed_avg, cluster_size = means, means, counts
        inited_t = torch.ones_like(state.inited)

    idx = nearest(x, embed)
    quantized = embed[idx]

    bins = embed.shape[0]
    counts, embed_sum = cluster_stats(F.one_hot(idx, bins).to(x.dtype), x, dp)
    new_cluster = cluster_size * decay + (1 - decay) * counts
    new_avg = embed_avg * decay + (1 - decay) * embed_sum
    n = torch.sum(new_cluster)
    smoothed = (new_cluster + LAPLACE_EPS) / (n + bins * LAPLACE_EPS) * n
    embed_normalized = new_avg / smoothed[:, None]
    if threshold > 0:
        expired = (new_cluster < threshold)[:, None]
        fresh = sample_vectors(x, bins, generator, expire_idx, dp)
        embed_normalized = torch.where(expired, fresh, embed_normalized)
        new_avg = torch.where(expired, fresh * smoothed[:, None], new_avg)
    return quantized, idx, StageState(inited_t, new_cluster, embed_normalized, new_avg)


def rvq_forward(states: Sequence[StageState], x: torch.Tensor, n_q: int, *,
                decay: float = 0.99, threshold_ema_dead_code: int = 2, kmeans_iters: int = 50,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
                inited: Optional[Sequence[bool]] = None,
                dp: Optional[DataParallel] = None):
    """Residual VQ training forward over the first ``n_q`` stages (all of
    them when ``n_q`` is larger, as the JAX package's mask does; the penalty
    is still divided by ``n_q``). Under ``dp``, ``x`` is this rank's rows of
    the global batch and the penalty this rank's (its mean over the ranks is
    the global one).

    ``x [B, T, D]``. Returns (quantized [B, T, D] with the straight-through
    gradient, codes [K, B, T] int32 (stages past n_q hold 0), penalty,
    new states: stages past ``n_q`` unchanged). ``draws[k]`` may hold stage
    k's ``init`` and ``expire`` row indices.
    """
    B, T, D = x.shape
    residual = x
    quantized_out = torch.zeros_like(x)
    total = x.new_zeros(())
    codes = torch.zeros(len(states), B, T, dtype=torch.int32, device=x.device)
    new_states = list(states)
    for k in range(min(n_q, len(states))):
        d = draws[k] if draws is not None else {}
        q, idx, new_states[k] = stage_train_forward(
            states[k], residual.reshape(B * T, D), decay=decay,
            threshold=threshold_ema_dead_code, kmeans_iters=kmeans_iters, generator=generator,
            init_idx=d.get('init'), expire_idx=d.get('expire'),
            inited=None if inited is None else inited[k], dp=dp)
        q = q.reshape(B, T, D)
        q_ste = residual + (q - residual).detach()
        total = total + torch.mean(torch.square(q - residual))
        quantized_out = quantized_out + q_ste
        residual = residual - q_ste.detach()
        codes[k] = idx.reshape(B, T).to(torch.int32)
    return quantized_out, codes, total / max(n_q, 1), new_states


def codebook_metrics(cluster_size: torch.Tensor, dead_threshold: float) -> Dict[str, torch.Tensor]:
    """Usage entropy (mean over stages, normalized to 1 = uniform) and the
    share of codes whose EMA cluster size is under the expiry threshold,
    from ``cluster_size [K, bins]``."""
    p = cluster_size / (torch.sum(cluster_size, -1, keepdim=True) + 1e-12)
    ent = -torch.sum(p * torch.log2(p + 1e-12), -1)
    bins = cluster_size.shape[-1]
    return {'codebook_entropy': torch.mean(ent) / math.log2(bins),
            'codebook_dead_frac': torch.mean((cluster_size < dead_threshold).float())}
