"""The quantizer's cached eval tables: the stacked codebooks and their squared
norms that kernel K1 reads (``ResidualVectorQuantization.tables``).

On the CPU the search runs K1's plain version; the cache sits above the
kernel wrapper, so what these tests hold (a repeated call reuses the tables,
any change to a codebook replaces them, cached and uncached codes are equal)
holds on the card too. Sizes are small: 8 stages of 64 bins at D 16.
"""

import numpy as np
import pytest
import torch

from encodec_pytorch_tpu_torch.ops import rvq_kernel
from encodec_pytorch_tpu_torch.quantization import core_vq
from encodec_pytorch_tpu_torch.quantization.vq import ResidualVectorQuantizer

N_Q, BINS, DIM = 8, 64, 16
FRAME_RATE = 75


def _quantizer(seed=0):
    rng = np.random.default_rng(seed)
    q = ResidualVectorQuantizer(dimension=DIM, n_q=N_Q, bins=BINS).eval()
    with torch.no_grad():
        for k, layer in enumerate(q.vq.layers):
            embed = rng.standard_normal((BINS, DIM)).astype(np.float32) * 0.7 ** k
            layer._codebook.embed.copy_(torch.from_numpy(embed))
            layer._codebook.embed_avg.copy_(torch.from_numpy(embed))
            layer._codebook.inited.fill_(1.)
    return q


def _latents(seed=1, B=2, T=30):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((B, DIM, T)).astype(np.float32))
    return z.transpose(1, 2)   # [B, T, D], as the model hands it over


def _fresh_codes(q, x, n_q):
    """The codes from codebooks stacked anew, no cache involved."""
    return core_vq.rvq_encode(q.vq.embeds(n_q), x)


def test_tables_are_reused_until_a_codebook_changes():
    q = _quantizer()
    embed, esq = q.vq.tables(N_Q)
    again = q.vq.tables(N_Q)
    assert again[0] is embed and again[1] is esq
    assert torch.equal(embed, q.vq.embeds(N_Q))
    assert torch.equal(esq, rvq_kernel.codebook_sq_norms(q.vq.embeds(N_Q)))
    # another n_q has its own entry and leaves this one in place
    small = q.vq.tables(4)
    assert small[0].shape == (4, BINS, DIM) and q.vq.tables(N_Q)[0] is embed
    with torch.no_grad():
        q.vq.layers[3]._codebook.embed.mul_(2.)
    new_embed, new_esq = q.vq.tables(N_Q)
    assert new_embed is not embed
    assert torch.equal(new_embed, q.vq.embeds(N_Q))
    assert torch.equal(new_esq, rvq_kernel.codebook_sq_norms(q.vq.embeds(N_Q)))


def test_codes_follow_set_states():
    q = _quantizer()
    x = _latents()
    before = q.encode(x, FRAME_RATE)
    assert torch.equal(before, _fresh_codes(q, x, N_Q))
    # reverse stage 0's bins: every code of stage 0 must move with them
    states = q.vq.states()
    perm = torch.arange(BINS - 1, -1, -1)
    states[0] = states[0]._replace(embed=states[0].embed[perm].clone(),
                                   embed_avg=states[0].embed_avg[perm].clone())
    q.vq.set_states(states)
    after = q.encode(x, FRAME_RATE)
    assert torch.equal(after, _fresh_codes(q, x, N_Q))
    assert torch.equal(after[0], (BINS - 1 - before[0]).to(torch.int32))
    assert torch.equal(after[1:], before[1:])
    # the decode reads the same cached stack
    assert torch.equal(q.decode(after), core_vq.rvq_decode(q.vq.embeds(N_Q), after))


def test_cached_and_uncached_codes_are_equal_at_every_bandwidth():
    q = _quantizer(seed=2)
    x = _latents(seed=3, B=3, T=17)
    for bandwidth in (0.9, 1.8, 3.6):   # 0.45 kbps a stage at 64 bins: n_q 2, 4, 8
        n_q = q.num_quantizers_for_bandwidth(FRAME_RATE, bandwidth)
        cached = q.encode(x, FRAME_RATE, bandwidth)
        assert cached.shape == (n_q, 3, 17) and cached.dtype == torch.int32
        assert torch.equal(cached, _fresh_codes(q, x, n_q))
        assert torch.equal(q.encode(x, FRAME_RATE, bandwidth), cached)


@pytest.mark.parametrize('how', ['train', 'load_state_dict'])
def test_a_training_update_or_a_load_replaces_the_tables(how):
    q = _quantizer(seed=4)
    x = _latents(seed=5)
    embed, _ = q.vq.tables(N_Q)
    if how == 'train':
        q.train()
        q.forward_train(x.contiguous(), N_Q, generator=torch.Generator().manual_seed(0))
        q.eval()
    else:
        q.load_state_dict(_quantizer(seed=6).state_dict())
    new_embed, _ = q.vq.tables(N_Q)
    assert new_embed is not embed and not torch.equal(new_embed, embed)
    assert torch.equal(new_embed, q.vq.embeds(N_Q))
    assert torch.equal(q.encode(x, FRAME_RATE), _fresh_codes(q, x, N_Q))


def test_wrapper_takes_batched_strided_latents_on_the_cpu():
    q = _quantizer(seed=7)
    x = _latents(seed=8, B=2, T=9)
    embed = q.vq.embeds(N_Q)
    codes = rvq_kernel.rvq_encode(x, embed)
    flat = rvq_kernel.rvq_encode_reference(x.reshape(18, DIM).contiguous(), embed)
    assert codes.shape == (N_Q, 2, 9) and torch.equal(codes.reshape(N_Q, 18), flat)
