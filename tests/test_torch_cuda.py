"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda`` marker and
skips without a card. This file imports no jax, so it runs on the GPU
machine, where ``tests/conftest.py`` (which needs jax) cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Shapes are ragged on purpose: rows and bins that are not multiples of the RVQ
kernel's tiles, and hidden sizes that do not divide the LSTM kernel's grid.
Bars: RVQ codes equal except where the first difference is a near-tie (the
rule of ``chip_smoke.rvq_first_differences``) at every rows-a-tile of the
cluster kernel, with ragged and empty bin slices; exact ties go to the lower
index, also across two CTAs' slices; strided latents give a contiguous copy's
codes; LSTM hidden states within 1e-5 at T <= 50, at B from 1 to 40 (one
batch pass of 16 rows and several) and at H that leaves a short last block;
chunks of 1, 4 or 7 steps with a carried (h, c) give the bits of one call. The
discriminator conv (K4, 3xTF32 on the tensor cores): forward and input
gradient within 1e-5 · max|ref| of ``F.conv2d`` and ``conv2d_input`` with
TF32 off, at both tap classes and every T dilation, with T and F sizes that
leave ragged tiles, and its weight-packing kernel bit-equal to the plain
packing; the trainable conv's three gradients likewise, and the LSTM's
autograd wrapper against autograd of the plain recurrence. K2 with a carried
(h, c) within 1e-5 of its plain version, and its zero-state call bit-equal to
the call without a state. The fused resblock (K3) within 1e-5 · max|ref| of
its plain version (``F.conv1d`` with TF32 off) at every width of the model,
dilation 1 and 2, causal and not, reflect and zero padding, ragged and short
T, with a streaming halo and at the mux tick's four shapes; chunks streamed
through it bit-equal to the offline call on the same samples at all four
widths, at C 512 and at C 36 (not a multiple of 4), with unaligned inputs and
weights (plain loads instead of cp.async and TMA); a SEANet block of 512
channels runs K3. K1 likewise at D 130, with unaligned codebooks, and with a
stage's slice in two buffers (M 2048 and 12000, ties across the buffers). The
launch shapes (K1's cluster and rows a tile, K3's cluster and tile) are the
documented ones. K5 (the discriminator's im2col conv, 3xTF32 on the tensor
cores) within 1e-5 · max|ref| of its plain version and of ``F.conv2d`` at
ragged tiles and every T dilation (Fo 33 and 65, T not a multiple of the
block's 16 rows, B 1 and 3), bit-equal across two calls, counting one launch
a call, with its weight-packing kernel bit-equal to the plain packing; its
trainable route's three gradients likewise; its bf16 form (a persistent
grid of 32-row x 16-column tiles) held to its plain version and to K4's
bf16 forward by the bf16 rule where only a persistent grid can go wrong (a
tile count the grid does not divide, fewer tiles than SMs, To around a
tile's rows, Fo = 2^k + 1 for k = 4 to 9) and at the 48 kHz call's 9 shapes,
and refusing a T dilation it is not built for; a
``time_group_norm`` model on the card never takes K3 and matches the CPU.
Trainer state on the card: a checkpoint written from the card loads back
bit-equal and a resumed trainer trains on; the test loop's step through the
kernels against their plain versions (codes >= 99 % equal, losses within
1e-3 relative); a weight-norm model folded on the card writes the raw
model's ``.ecdc`` bytes, through K3. K6 (the LM coder): its bytes equal its
plain version's and the C++ host coder's at K 4, 8 and 32 (card 1024), card
200, 16 and 4096 (one row a group of bins), and on one-hot and uniform pdfs; decode, a launch a step, returns
the symbols; its CDFs equal the host build bit for bit; a truncated stream
sets ``overrun`` and a symbol outside the card ``overflow``; the on-device coder with a small LM on the card round-trips
codes with no host sync inside either step loop and raises EOFError on a
truncated stream. K6's stall mode equals its plain version (symbols, the
whole state, the stall decision) at K 4, 8, 32 and card 16, 1024, 4096 with
the stream cut to stall at a step's first symbol, in mid-step and never; an
encode on a buffer rebased as the streaming encoder rebases it (the partial
byte kept) equals the plain version's, in one launch, in two and as the
flush alone; encodes in chunks of 1 to 100 steps give one call's bytes;
many steps decode in one launch whose ring of rows wraps; the wrapper
refuses other dtypes, devices, shapes and layouts. The int8-weight entries of K2 and K3 (``prepare.quantize_weights``'s
twin) give the bits of the f32 entries on the dequantized weights and hold
their plain versions, K3's at every width (C 4, 8, 12 and 36 whose rows break
TMA's 16-byte rule, and unaligned int8 weights, take the plain loads), and
``LiveCodec(weights='int8')`` on the card runs them, equal to the f32 path on
the dequantized model.
"""

import pytest
import torch

import chip_smoke
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.models.seanet import SEANetResnetBlock
from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
from encodec_pytorch_tpu_torch.ops import lstm, lstm_kernel, resblock_kernel, rvq_kernel
from encodec_pytorch_tpu_torch.ops.int8 import dequantize_int8, quantize_int8

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with nvcc')
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize('M,K,N,D', [(1000, 5, 1000, 128), (33, 3, 64, 64), (1, 1, 7, 5)])
def test_rvq_kernel_matches_plain(cuda, M, K, N, D):
    gen = torch.Generator(device=cuda).manual_seed(M + N)
    x = torch.randn(M, D, generator=gen, device=cuda)
    embed = torch.randn(K, N, D, generator=gen, device=cuda)
    codes = rvq_kernel.rvq_encode(x, embed)
    plain = rvq_kernel.rvq_encode_reference(x, embed)
    assert codes.shape == (K, M) and codes.dtype == torch.int32
    n_diff, not_tie = chip_smoke.rvq_first_differences(torch, x, embed, codes, plain)
    assert not_tie == 0, (n_diff, not_tie)


def test_rvq_kernel_exact_tie_takes_lower_index(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    embed = torch.randn(2, 300, 128, generator=gen, device=cuda)
    embed[0, 250] = embed[0, 70]              # bins 70 and 250 tie exactly
    x = embed[0, 70].repeat(40, 1).contiguous()
    codes = rvq_kernel.rvq_encode(x, embed)
    assert bool((codes[0] == 70).all())
    assert torch.equal(codes, rvq_kernel.rvq_encode_reference(x, embed))


@pytest.mark.parametrize('N', [1024, 1000, 7])
@pytest.mark.parametrize('K', [1, 8, 32])
@pytest.mark.parametrize('M', [1, 8, 64, 750])
def test_rvq_kernel_cluster_shapes_match_plain(cuda, M, K, N):
    """The cluster kernel at the serving path's and the codec's M: every rows
    a tile from 1 to 32, a ragged last slice (N 1000: 125 bins a CTA) and
    fewer bins than CTAs (N 7: the last CTA of the cluster owns none)."""
    gen = torch.Generator(device=cuda).manual_seed(M * 100 + K * 10 + N)
    D = 128
    x = torch.randn(M, D, generator=gen, device=cuda)
    scale = 0.7 ** torch.arange(K, device=cuda, dtype=torch.float32)
    embed = (torch.randn(K, N, D, generator=gen, device=cuda) * scale[:, None, None]).contiguous()
    esq = rvq_kernel.codebook_sq_norms(embed)
    codes = rvq_kernel.rvq_encode(x, embed, esq)
    plain = rvq_kernel.rvq_encode_reference(x, embed)
    assert codes.shape == (K, M) and codes.dtype == torch.int32
    assert bool((codes >= 0).all()) and bool((codes < N).all())
    n_diff, not_tie = chip_smoke.rvq_first_differences(torch, x, embed, codes, plain)
    assert not_tie == 0, (n_diff, not_tie)
    assert torch.equal(codes, rvq_kernel.rvq_encode(x, embed))   # esq computed in the wrapper


@pytest.mark.parametrize('N,first,second', [(1024, 127, 128), (1024, 900, 1023),
                                             (1000, 124, 125), (1000, 880, 999)])
def test_rvq_kernel_tie_across_cluster_ranks_takes_lower_index(cuda, N, first, second):
    """An exact tie between the last bin of one CTA's slice and the first of
    the next (N 1024: 128 bins a CTA; N 1000: 125), and one inside the last
    slice: every CTA of the cluster must agree on the lower index."""
    gen = torch.Generator(device=cuda).manual_seed(N + first)
    embed = torch.randn(2, N, 128, generator=gen, device=cuda)
    embed[0, second] = embed[0, first]
    for M in (8, 64, 750):
        x = embed[0, first].repeat(M, 1).contiguous()
        codes = rvq_kernel.rvq_encode(x, embed)
        assert bool((codes[0] == first).all()), (M, codes[0].unique())
        assert torch.equal(codes, rvq_kernel.rvq_encode_reference(x, embed))


def test_rvq_kernel_reads_strided_latents(cuda):
    """The encoder's latents arrive as [B, T, D] transposed from [B, D, T]:
    the kernel reads them in place and gives the codes of a contiguous copy."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    z = torch.randn(3, 128, 50, generator=gen, device=cuda)
    embed = torch.randn(4, 1024, 128, generator=gen, device=cuda)
    x = z.transpose(1, 2)
    codes = rvq_kernel.rvq_encode(x, embed)
    flat = rvq_kernel.rvq_encode(x.reshape(150, 128).contiguous(), embed)
    assert codes.shape == (4, 3, 50) and torch.equal(codes.reshape(4, 150), flat)


def _unaligned(t):
    """A contiguous copy of ``t`` one float past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0
    return out.copy_(t)


@pytest.mark.parametrize('M', [64, 750])
def test_rvq_kernel_plain_loads_match_plain(cuda, M):
    """The codebook slices by plain loads instead of TMA: at D 130 (not a
    multiple of 4) and with codebooks one float past a 16-byte boundary."""
    gen = torch.Generator(device=cuda).manual_seed(M)
    for D, shift in ((130, False), (128, True)):
        x = torch.randn(M, D, generator=gen, device=cuda)
        embed = torch.randn(8, 1000, D, generator=gen, device=cuda)
        if shift:
            embed = _unaligned(embed)
        codes = rvq_kernel.rvq_encode(x, embed)
        plain = rvq_kernel.rvq_encode_reference(x, embed)
        n_diff, not_tie = chip_smoke.rvq_first_differences(torch, x, embed, codes, plain)
        assert not_tie == 0, (D, shift, n_diff, not_tie)
        if shift:   # the same scores as the aligned copy's TMA path
            assert torch.equal(codes, rvq_kernel.rvq_encode(x, embed.clone()))


@pytest.mark.parametrize('first,second', [(63, 64), (447, 448), (1000, 1001)])
def test_rvq_kernel_half_slice_buffers(cuda, first, second):
    """Past 16 tiles a stage's slice of 128 bins goes through two 64-bin
    buffers, the best carried from one to the next: codes match the plain
    version at M 2048 and 12000, and an exact tie across the two buffers of
    one CTA (bins 63/64, 447/448) or inside the second (1000/1001) takes the
    lower index."""
    assert rvq_kernel.launch_config(2048, 1024)['bins_per_buffer'] == 64
    gen = torch.Generator(device=cuda).manual_seed(first)
    embed = torch.randn(8, 1024, 128, generator=gen, device=cuda)
    for M in (2048, 12000):
        x = torch.randn(M, 128, generator=gen, device=cuda)
        codes = rvq_kernel.rvq_encode(x, embed)
        plain = rvq_kernel.rvq_encode_reference(x, embed)
        n_diff, not_tie = chip_smoke.rvq_first_differences(torch, x, embed, codes, plain)
        assert not_tie == 0, (M, n_diff, not_tie)
    embed[0, second] = embed[0, first]
    x = embed[0, first].repeat(2048, 1).contiguous()
    codes = rvq_kernel.rvq_encode(x, embed)
    assert bool((codes[0] == first).all()), codes[0].unique()
    assert torch.equal(codes, rvq_kernel.rvq_encode_reference(x, embed))


def test_kernel_launch_configs(cuda):
    """K1 spreads small M over the card in clusters of 8, with a stage's whole
    slice a buffer until the grid outgrows the card; K3 splits a tile's rows
    over clusters of 2 / 2 / 4 / 8 / 8 CTAs at C 32 / 64 / 128 / 256 / 512 and
    takes nothing wider."""
    for M, rows, bins in ((12000, 64, 64), (750, 64, 128), (64, 8, 128), (8, 1, 128),
                          (1, 1, 128)):
        cfg = rvq_kernel.launch_config(M, 1024)
        assert cfg == {'cluster': 8, 'rows_per_tile': rows, 'bins_per_buffer': bins}, (M, cfg)
    for C, cl, tile in ((32, 2, 256), (64, 2, 128), (128, 4, 64), (256, 8, 32), (512, 8, 32),
                        (1024, 0, 0)):
        assert resblock_kernel.launch_config(C, C // 2) == {'cluster': cl, 'tile': tile}


@pytest.mark.parametrize('T,B,H', [(50, 3, 100), (20, 2, 512), (5, 17, 33)])
def test_lstm_kernel_matches_plain(cuda, T, B, H):
    gen = torch.Generator(device=cuda).manual_seed(T * B + H)
    bound = 1 / H ** 0.5
    xp = torch.randn(T, B, 4 * H, generator=gen, device=cuda)
    w_hh = (torch.rand(4 * H, H, generator=gen, device=cuda) * 2 - 1) * bound
    h, c = lstm_kernel.lstm_recurrence(xp, w_hh)
    ref, ref_c = lstm_kernel.lstm_recurrence_reference(xp, w_hh)
    assert h.shape == (T, B, H) and c.shape == (B, H)
    assert float((h - ref).abs().max()) <= 1e-5 and float((c - ref_c).abs().max()) <= 1e-5


@pytest.mark.parametrize('T,B,H', [(4, 16, 512), (50, 3, 100), (1, 17, 33)])
def test_lstm_kernel_carried_state_matches_plain(cuda, T, B, H):
    gen = torch.Generator(device=cuda).manual_seed(T + B * H)
    bound = 1 / H ** 0.5
    xp = torch.randn(T, B, 4 * H, generator=gen, device=cuda)
    w_hh = (torch.rand(4 * H, H, generator=gen, device=cuda) * 2 - 1) * bound
    h0 = torch.randn(B, H, generator=gen, device=cuda) * 0.5
    c0 = torch.randn(B, H, generator=gen, device=cuda)
    h, c = lstm_kernel.lstm_recurrence(xp, w_hh, h0, c0)
    ref, ref_c = lstm_kernel.lstm_recurrence_reference(xp, w_hh, h0, c0)
    assert float((h - ref).abs().max()) <= 1e-5 and float((c - ref_c).abs().max()) <= 1e-5
    # two halves with the state carried between them: the same bits as one call
    h1, c1 = lstm_kernel.lstm_recurrence(xp[:T // 2].contiguous(), w_hh, h0, c0)
    start = h1[-1] if T // 2 else h0
    h2, c2 = lstm_kernel.lstm_recurrence(xp[T // 2:].contiguous(), w_hh, start.contiguous(), c1)
    assert torch.equal(torch.cat([h1, h2]), h) and torch.equal(c2, c)


@pytest.mark.parametrize('B', [1, 3, 16, 17, 32, 40])
@pytest.mark.parametrize('H', [512, 265, 1000])
def test_lstm_kernel_batches_match_plain(cuda, B, H):
    # H 512: 4 units a block on 132 SMs; H 265: 3 units a block, the last block
    # 1; H 1000: 8 units a block, 512 threads
    gen = torch.Generator(device=cuda).manual_seed(B * H)
    T, bound = 20, 1 / H ** 0.5
    xp = torch.randn(T, B, 4 * H, generator=gen, device=cuda)
    w_hh = (torch.rand(4 * H, H, generator=gen, device=cuda) * 2 - 1) * bound
    h0 = torch.randn(B, H, generator=gen, device=cuda) * 0.5
    c0 = torch.randn(B, H, generator=gen, device=cuda)
    for state in ((), (h0, c0)):
        h, c = lstm_kernel.lstm_recurrence(xp, w_hh, *state)
        ref, ref_c = lstm_kernel.lstm_recurrence_reference(xp, w_hh, *state)
        assert float((h - ref).abs().max()) <= 1e-5 and float((c - ref_c).abs().max()) <= 1e-5


def test_lstm_kernel_splits_batches_past_shared_memory(cuda):
    # H 1000 holds 48 batch rows a launch in 227 KB of shared memory: 50 take two
    gen = torch.Generator(device=cuda).manual_seed(50)
    T, B, H = 6, 50, 1000
    xp = torch.randn(T, B, 4 * H, generator=gen, device=cuda)
    w_hh = (torch.rand(4 * H, H, generator=gen, device=cuda) * 2 - 1) / H ** 0.5
    h0 = torch.randn(B, H, generator=gen, device=cuda) * 0.5
    c0 = torch.randn(B, H, generator=gen, device=cuda)
    h, c = lstm_kernel.lstm_recurrence(xp, w_hh, h0, c0)
    ref, ref_c = lstm_kernel.lstm_recurrence_reference(xp, w_hh, h0, c0)
    assert float((h - ref).abs().max()) <= 1e-5 and float((c - ref_c).abs().max()) <= 1e-5


@pytest.mark.parametrize('chunk', [1, 4, 7])
@pytest.mark.parametrize('B,H', [(16, 512), (3, 100)])
def test_lstm_kernel_carried_chunks_are_one_call(cuda, chunk, B, H):
    gen = torch.Generator(device=cuda).manual_seed(chunk + B)
    T = 23
    xp = torch.randn(T, B, 4 * H, generator=gen, device=cuda)
    w_hh = (torch.rand(4 * H, H, generator=gen, device=cuda) * 2 - 1) / H ** 0.5
    h0 = torch.randn(B, H, generator=gen, device=cuda) * 0.5
    c0 = torch.randn(B, H, generator=gen, device=cuda)
    h_all, c_all = lstm_kernel.lstm_recurrence(xp, w_hh, h0, c0)
    hs, h, c = [], h0, c0
    for t in range(0, T, chunk):
        out, c = lstm_kernel.lstm_recurrence(xp[t:t + chunk].contiguous(), w_hh, h, c)
        hs.append(out)
        h = out[-1].contiguous()
    assert torch.equal(torch.cat(hs), h_all) and torch.equal(c, c_all)


def test_lstm_step_profile_reports_the_parts(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    xp = torch.randn(30, 16, 4 * 512, generator=gen, device=cuda)
    w_hh = torch.randn(4 * 512, 512, generator=gen, device=cuda) / 23
    launches = lstm_kernel.lstm_recurrence.launches
    p = lstm_kernel.lstm_step_profile(xp, w_hh)
    assert lstm_kernel.lstm_recurrence.launches == launches
    assert p['cycles'] > 0 and all(p[k] > 0 for k in lstm_kernel.STEP_PARTS)
    assert 0.9 < sum(p[k] for k in lstm_kernel.STEP_PARTS) <= 1.0


def test_lstm_kernel_zero_state_is_the_offline_call(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    xp = torch.randn(30, 4, 4 * 64, generator=gen, device=cuda)
    w_hh = torch.randn(4 * 64, 64, generator=gen, device=cuda) / 8
    zeros = torch.zeros(4, 64, device=cuda)
    h, c = lstm_kernel.lstm_recurrence(xp, w_hh)
    hz, cz = lstm_kernel.lstm_recurrence(xp, w_hh, zeros, zeros)
    assert torch.equal(h, hz) and torch.equal(c, cz)


def _resblock_weights(C, gen, device):
    H = C // 2

    def u(*shape, fan):
        return ((torch.rand(*shape, generator=gen, device=device) * 2 - 1) / fan ** 0.5)
    return (u(H, C, 3, fan=3 * C), u(H, fan=3 * C) * 0.3, u(C, H, 1, fan=H), u(C, fan=H) * 0.3,
            u(C, C, 1, fan=C), u(C, fan=C) * 0.3)


@pytest.mark.parametrize('C', [32, 64, 128, 256, 512, 36])
@pytest.mark.parametrize('d', [1, 2])
def test_resblock_kernel_matches_plain(cuda, C, d):
    gen = torch.Generator(device=cuda).manual_seed(C + d)
    w = _resblock_weights(C, gen, cuda)
    for T in (1000, 2 * d + 1, 2 * d):
        x = torch.randn(2, C, T, generator=gen, device=cuda)
        for causal in (True, False):
            for pad_mode in ('reflect', 'constant'):
                kw = dict(dilation=d, causal=causal, pad_mode=pad_mode)
                got = resblock_kernel.resblock(x, *w, **kw)
                ref = resblock_kernel.resblock_reference(x, *w, **kw)
                assert _rel_max(got, ref) <= 1e-5, (T, causal, pad_mode)
        left = torch.randn(2, C, 2 * d, generator=gen, device=cuda)
        got, carry = resblock_kernel.resblock(x, *w, dilation=d, causal=True, left=left,
                                              return_carry=True)
        ref, ref_carry = resblock_kernel.resblock_reference(x, *w, dilation=d, causal=True,
                                                            left=left, return_carry=True)
        assert _rel_max(got, ref) <= 1e-5 and _rel_max(carry, ref_carry) <= 1e-6


@pytest.mark.parametrize('C,T', [(32, 1280), (64, 640), (128, 160), (256, 32)])
def test_resblock_kernel_tick_shapes_match_plain(cuda, C, T):
    """The mux tick's four encoder blocks (16 slots x 4 hops) with a halo."""
    gen = torch.Generator(device=cuda).manual_seed(C + T)
    w = _resblock_weights(C, gen, cuda)
    x = torch.randn(16, C, T, generator=gen, device=cuda)
    left = torch.randn(16, C, 2, generator=gen, device=cuda)
    got, carry = resblock_kernel.resblock(x, *w, dilation=1, causal=True, left=left,
                                          return_carry=True)
    ref, ref_carry = resblock_kernel.resblock_reference(x, *w, dilation=1, causal=True,
                                                        left=left, return_carry=True)
    assert _rel_max(got, ref) <= 1e-5 and _rel_max(carry, ref_carry) <= 1e-6


@pytest.mark.parametrize('C', [32, 64, 128, 256, 512, 36])
def test_resblock_streamed_chunks_bit_equal_offline(cuda, C):
    gen = torch.Generator(device=cuda).manual_seed(7)
    w = _resblock_weights(C, gen, cuda)
    x = torch.randn(3, C, 2000, generator=gen, device=cuda)
    offline = resblock_kernel.resblock(x, *w, dilation=1, causal=True)
    outs, left, pos = [], None, 0
    for n in (700, 37, 640, 623):
        out, left = resblock_kernel.resblock(x[..., pos:pos + n].contiguous(), *w, dilation=1,
                                             causal=True, left=left, return_carry=True)
        outs.append(out)
        pos += n
    assert torch.equal(torch.cat(outs, -1), offline)


def test_resblock_kernel_unaligned_inputs_match_plain(cuda):
    """The input and the weights one float past a 16-byte boundary: the tile
    by plain loads instead of cp.async, the weight chunks by plain loads
    instead of TMA; the same bits as aligned copies."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = _resblock_weights(64, gen, cuda)
    x = torch.randn(2, 64, 300, generator=gen, device=cuda)
    kw = dict(dilation=1, causal=False, pad_mode='reflect')
    got = resblock_kernel.resblock(_unaligned(x), *(_unaligned(t) for t in w), **kw)
    assert _rel_max(got, resblock_kernel.resblock_reference(x, *w, **kw)) <= 1e-5
    assert torch.equal(got, resblock_kernel.resblock(x, *w, **kw))


@pytest.mark.parametrize('causal', [True, False])
def test_seanet_block_512_takes_the_kernel(cuda, causal):
    """A SEANet block of 512 channels (n_filters 64) runs K3 on the card with
    gradients off, like the narrower ones, and matches its conv sequence."""
    block = SEANetResnetBlock(512, 'weight_norm', causal, 'reflect',
                              torch.Generator().manual_seed(0)).to(cuda)
    x = torch.randn(2, 512, 500, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    launches = resblock_kernel.resblock.launches
    with torch.no_grad():
        got = block(x)
        assert resblock_kernel.resblock.launches == launches + 1
        ref = block.shortcut(x) + block.block(x)   # the conv sequence
    assert _rel_max(got, ref) <= 1e-5


@pytest.mark.parametrize('T,B,H,carried', [(50, 3, 100, False), (20, 2, 512, False),
                                           (4, 16, 512, True), (5, 17, 33, True)])
def test_lstm_int8_kernel_is_the_f32_kernel_on_dequantized_weights(cuda, T, B, H, carried):
    gen = torch.Generator(device=cuda).manual_seed(T + B + H)
    xp = torch.randn(T, B, 4 * H, generator=gen, device=cuda)
    q8, scale = quantize_int8(torch.randn(4 * H, H, generator=gen, device=cuda) / H ** 0.5)
    state = ((torch.randn(B, H, generator=gen, device=cuda),
              torch.randn(B, H, generator=gen, device=cuda)) if carried else ())
    launches = lstm_kernel.lstm_recurrence_int8.launches
    h, c = lstm_kernel.lstm_recurrence_int8(xp, q8, scale, *state)
    assert lstm_kernel.lstm_recurrence_int8.launches == launches + 1
    h32, c32 = lstm_kernel.lstm_recurrence(xp, dequantize_int8(q8, scale), *state)
    assert torch.equal(h, h32) and torch.equal(c, c32)
    hp, cp = lstm_kernel.lstm_recurrence_int8_reference(xp, q8, scale, *state)
    assert float((h - hp).abs().max()) <= 1e-5 and float((c - cp).abs().max()) <= 1e-5


def _int8_resblock_weights(C, gen, device):
    k1, b1, k2, b2, ks, bs = _resblock_weights(C, gen, device)
    (q1, s1), (q2, s2), (qs, ss) = (quantize_int8(w) for w in (k1, k2, ks))
    return (q1, s1, b1, q2, s2, b2, qs, ss, bs)


def _dequantized(w8):
    q1, s1, b1, q2, s2, b2, qs, ss, bs = w8
    return (dequantize_int8(q1, s1), b1, dequantize_int8(q2, s2), b2, dequantize_int8(qs, ss),
            bs)


@pytest.mark.parametrize('C', [32, 64, 128, 256, 512, 36, 4, 8, 12])
@pytest.mark.parametrize('d', [1, 2])
def test_resblock_int8_kernel_is_the_f32_kernel_on_dequantized_weights(cuda, C, d):
    """Every width: the 16-byte TMA rows (C and H multiples of 16) and the
    plain int8 loads (C 4, 8, 12, 36)."""
    gen = torch.Generator(device=cuda).manual_seed(C + d)
    w8 = _int8_resblock_weights(C, gen, cuda)
    w32 = _dequantized(w8)
    for T in (1000, 2 * d + 1):
        x = torch.randn(2, C, T, generator=gen, device=cuda)
        for causal in (True, False):
            kw = dict(dilation=d, causal=causal, pad_mode='reflect')
            got = resblock_kernel.resblock_int8(x, *w8, **kw)
            assert torch.equal(got, resblock_kernel.resblock(x, *w32, **kw)), (T, causal)
            assert _rel_max(got, resblock_kernel.resblock_int8_reference(x, *w8, **kw)) <= 1e-5
        left = torch.randn(2, C, 2 * d, generator=gen, device=cuda)
        kw = dict(dilation=d, causal=True, left=left, return_carry=True)
        got = resblock_kernel.resblock_int8(x, *w8, **kw)
        want = resblock_kernel.resblock(x, *w32, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_resblock_int8_unaligned_weights_take_plain_loads(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    w8 = _int8_resblock_weights(64, gen, cuda)
    x = torch.randn(2, 64, 300, generator=gen, device=cuda)
    kw = dict(dilation=1, causal=True)
    moved = tuple(_unaligned(t) if t.dtype == torch.int8 else t for t in w8)
    assert torch.equal(resblock_kernel.resblock_int8(x, *moved, **kw),
                       resblock_kernel.resblock_int8(x, *w8, **kw))
    with pytest.raises(TypeError):
        resblock_kernel.resblock_int8(x, *_dequantized(w8)[:1], *w8[1:], **kw)
    with pytest.raises(ValueError, match='scale'):
        resblock_kernel.resblock_int8(x, w8[0], w8[1][:-1].contiguous(), *w8[2:], **kw)
    with pytest.raises(TypeError):
        lstm_kernel.lstm_recurrence_int8(torch.randn(3, 2, 32, device=cuda),
                                         torch.randn(32, 8, device=cuda),
                                         torch.ones(32, device=cuda))


def test_int8_live_codec_on_the_card(cuda):
    """``LiveCodec(weights='int8')`` on the card: K2's and K3's int8 entries
    (never the f32 ones), codes and decode equal to the f32 path on the
    dequantized model, and close to the int8 twin on the CPU."""
    import numpy as np

    from encodec_pytorch_tpu_torch import prepare
    from encodec_pytorch_tpu_torch.serve import LiveCodec
    model = EncodecModel._get_model([1.5, 3., 6.], 24000, 1, causal=True, n_q=8,
                                    n_filters=8, name='encodec_24khz',
                                    generator=torch.Generator().manual_seed(7)).eval()
    gen = torch.Generator().manual_seed(8)
    for layer in model.quantizer.vq.layers:
        layer._codebook.embed.normal_(generator=gen)
    cpu = LiveCodec(model, weights='int8', device='cpu')
    live = LiveCodec(model.cuda(), weights='int8', device='cuda')
    deq = LiveCodec(prepare.dequantize_weights(live.model), device='cuda')
    x = (np.random.default_rng(9).standard_normal((2, 1, 24000)) * 0.1).astype(np.float32)
    chip_smoke.reset_counts()
    codes = live.encode(x, bandwidth=6.)
    out = live.decode(codes, bandwidth=6.)
    counts = chip_smoke.read_counts(chip_smoke.CODEC_KERNELS + chip_smoke.INT8_KERNELS)
    assert counts['lstm_recurrence_int8'] == 4 and counts['resblock_int8'] == 8, counts
    assert counts['lstm_recurrence'] == 0 and counts['resblock'] == 0, counts
    codes_d = deq.encode(x, bandwidth=6.)
    assert torch.equal(codes[0], codes_d[0])
    assert torch.equal(out, deq.decode(codes, bandwidth=6.))
    codes_cpu = cpu.encode(x, bandwidth=6.)
    assert float((codes[0].cpu() == codes_cpu[0]).float().mean()) >= 0.99
    if torch.equal(codes[0].cpu(), codes_cpu[0]):
        assert torch.allclose(out.cpu(), cpu.decode(codes_cpu, bandwidth=6.), atol=2e-4,
                              rtol=1e-4)


def test_resblock_rejects_what_it_does_not_take(cuda):
    w = _resblock_weights(32, torch.Generator(device=cuda).manual_seed(0), cuda)
    x = torch.randn(2, 32, 100, device=cuda)
    with pytest.raises(TypeError):
        resblock_kernel.resblock(x.double(), *(t.double() for t in w), dilation=1, causal=True)
    with pytest.raises(ValueError, match='contiguous'):
        resblock_kernel.resblock(x.transpose(0, 1).contiguous().transpose(0, 1), *w,
                                 dilation=1, causal=True)
    with pytest.raises(ValueError, match='weights'):
        resblock_kernel.resblock(x, w[0][..., :2].contiguous(), *w[1:], dilation=1, causal=True)
    with pytest.raises(ValueError, match='causal'):
        resblock_kernel.resblock(x, *w, dilation=1, causal=False,
                                 left=torch.zeros(2, 32, 2, device=cuda))
    with pytest.raises(ValueError, match='CUDA device'):
        resblock_kernel.resblock(x.cpu(), *w, dilation=1, causal=True)
    with pytest.raises(ValueError, match='pad mode'):
        resblock_kernel.resblock(x, *w, dilation=1, causal=True, pad_mode='replicate')


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(10, 8, device=cuda)
    with pytest.raises(TypeError):
        rvq_kernel.rvq_encode(x.double(), torch.randn(1, 4, 8, device=cuda).double())
    with pytest.raises(ValueError):     # D 8 against codebooks of D 10
        rvq_kernel.rvq_encode(x, torch.randn(1, 4, 10, device=cuda))
    with pytest.raises(ValueError, match='contiguous'):
        rvq_kernel.rvq_encode(x, torch.randn(1, 8, 4, device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match='esq'):
        rvq_kernel.rvq_encode(x, torch.randn(1, 4, 8, device=cuda), torch.zeros(1, 5, device=cuda))
    with pytest.raises(ValueError):
        lstm_kernel.lstm_recurrence(torch.randn(3, 2, 8, device=cuda),
                                    torch.randn(8, 3, device=cuda))


def test_tiny_model_cuda_matches_cpu(cuda):
    model = EncodecModel._get_model([6.], n_q=8, n_filters=4, name='encodec_24khz').eval()
    gen = torch.Generator().manual_seed(0)
    for layer in model.quantizer.vq.layers:
        layer._codebook.embed.normal_(generator=gen)
    model.set_target_bandwidth(6.)
    x = torch.randn(2, 1, 4800, generator=gen) * 0.1
    codes_cpu = model.encode(x)[0][0]
    out_cpu = model(x)
    model.to(cuda)
    rvq_kernel.rvq_encode.launches = lstm_kernel.lstm_recurrence.launches = 0
    resblock_kernel.resblock.launches = 0
    codes = model.encode(x.to(cuda))[0][0].cpu()
    out = model(x.to(cuda)).cpu()
    assert rvq_kernel.rvq_encode.launches == 2 and lstm_kernel.lstm_recurrence.launches == 6
    assert resblock_kernel.resblock.launches == 12
    assert float((codes == codes_cpu).float().mean()) >= 0.99
    if torch.equal(codes, codes_cpu):   # a near-tie flip would change the decode locally
        assert torch.allclose(out, out_cpu, atol=2e-4, rtol=1e-4)


def _rel_max(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


# (B, Cin, Cout, T, F, kernel, stride, dilation, padding): conv_1..3 and
# conv_4 of a scale, with F sizes that leave ragged 64-column tiles
DISC_CASES = [
    (2, 32, 32, 13, 65, (3, 9), (1, 2), (1, 1), (1, 4)),
    (2, 32, 32, 13, 129, (3, 9), (1, 2), (2, 1), (2, 4)),
    (1, 32, 32, 20, 33, (3, 9), (1, 2), (4, 1), (4, 4)),
    (3, 32, 32, 7, 100, (3, 3), (1, 1), (1, 1), (1, 1)),
    (1, 40, 64, 5, 70, (3, 9), (1, 2), (1, 1), (1, 4)),
    # ragged T and F tails past the 16-row, 32-column tiles at every dilation
    (2, 32, 32, 37, 257, (3, 9), (1, 2), (4, 1), (4, 4)),
    (1, 32, 32, 19, 130, (3, 9), (1, 2), (2, 1), (2, 4)),
    (2, 32, 32, 37, 33, (3, 3), (1, 1), (2, 1), (2, 1)),
    (1, 32, 32, 19, 65, (3, 3), (1, 1), (4, 1), (4, 1)),
    (1, 36, 40, 17, 41, (3, 3), (1, 1), (1, 1), (1, 1)),
]


@pytest.mark.parametrize('B,Cin,Cout,T,F,k,stride,dilation,padding', DISC_CASES)
def test_disc_conv_kernel_matches_plain(cuda, B, Cin, Cout, T, F, k, stride, dilation, padding):
    gen = torch.Generator(device=cuda).manual_seed(T * F + Cin)
    x = torch.randn(B, Cin, T, F, generator=gen, device=cuda)
    w = torch.randn(Cout, Cin, *k, generator=gen, device=cuda) / (Cin * k[0] * k[1]) ** 0.5
    b = torch.randn(Cout, generator=gen, device=cuda)
    y = dck.disc_conv_forward(x, w, b, stride, dilation, padding)
    ref = dck.disc_conv_forward_reference(x, w, b, stride, dilation, padding)
    assert y.shape == ref.shape
    assert _rel_max(y, ref) <= 1e-5
    g = torch.randn(ref.shape, generator=gen, device=cuda)
    dx = dck.disc_conv_input_grad(g, w, x.shape, stride, dilation, padding)
    dx_ref = dck.disc_conv_input_grad_reference(g, w, x.shape, stride, dilation, padding)
    assert _rel_max(dx, dx_ref) <= 1e-5
    # same bits on a second run: the gather form has no atomics
    assert torch.equal(dx, dck.disc_conv_input_grad(g, w, x.shape, stride, dilation, padding))


@pytest.mark.parametrize('T,F,k,stride,dilation,padding', [
    (64, 257, (3, 9), (1, 2), (1, 1), (1, 4)),
    (64, 129, (3, 3), (1, 1), (2, 1), (2, 1))])
def test_disc_conv_kernel_holds_float64_without_a_bias(cuda, T, F, k, stride, dilation,
                                                       padding):
    """K4 against the float64 conv at a discriminator shape (32 channels, the
    input a leaky ReLU's, as the discriminator feeds it): within 1e-6 by
    relative norm, forward and input gradient, and no drift of the outputs
    toward zero. A k-step's products summed onto the running sum inside the
    tensor core drop bits toward zero; that bias put the outputs ~5e-6 from
    float64 (cuDNN: under 5e-7) before each k-step was summed from zero and
    added by a rounding f32 add."""
    gen = torch.Generator(device=cuda).manual_seed(T + F)
    x = torch.nn.functional.leaky_relu(torch.randn(4, 32, T, F, generator=gen, device=cuda), 0.2)
    w = torch.randn(32, 32, *k, generator=gen, device=cuda) / (32 * k[0] * k[1]) ** 0.5
    b = torch.randn(32, generator=gen, device=cuda) * 0.1
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    y64 = torch.nn.functional.conv2d(x.double(), w.double(), b.double(), **kw)
    g = torch.randn(y64.shape, generator=gen, device=cuda)
    dx64 = torch.nn.grad.conv2d_input(x.shape, w.double(), g.double(), **kw)
    for got, ref in ((dck.disc_conv_forward(x, w, b, stride, dilation, padding), y64),
                     (dck.disc_conv_input_grad(g, w, x.shape, stride, dilation, padding), dx64)):
        d = got.double() - ref
        assert float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref)) <= 1e-6
        assert abs(float((d * ref.sign()).mean() / ref.abs().mean())) <= 1e-7


@pytest.mark.parametrize('Cout,Cin,k,sf', [(32, 32, (3, 9), 2), (32, 32, (3, 3), 1),
                                            (64, 40, (3, 9), 2), (40, 36, (3, 3), 1)])
def test_disc_conv_pack_kernel_is_the_plain_packing(cuda, Cout, Cin, k, sf):
    gen = torch.Generator(device=cuda).manual_seed(Cout + Cin)
    w = torch.randn(Cout, Cin, *k, generator=gen, device=cuda)
    assert torch.equal(dck.pack_weight_cuda(w, sf, dx=False),
                       dck.pack_weight(w.permute(1, 2, 3, 0)[None]))
    assert torch.equal(dck.pack_weight_cuda(w, sf, dx=True),
                       dck.pack_weight(dck.pack_dx_weight(w, sf)))


def test_disc_conv_autograd_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 32, 11, 57, generator=gen, device=cuda, requires_grad=True)
    w = (torch.randn(32, 32, 3, 9, generator=gen, device=cuda) / 30).requires_grad_()
    b = torch.randn(32, generator=gen, device=cuda, requires_grad=True)
    g = torch.randn(2, 32, 11, 29, generator=gen, device=cuda)
    launches = dck.disc_conv_forward.launches, dck.disc_conv_input_grad.launches
    grads = torch.autograd.grad(dck.disc_conv(x, w, b, (1, 2), (1, 1), (1, 4)), (x, w, b), g)
    assert (dck.disc_conv_forward.launches, dck.disc_conv_input_grad.launches) == (
        launches[0] + 1, launches[1] + 1)
    ref = torch.autograd.grad(torch.nn.functional.conv2d(x, w, b, (1, 2), (1, 4), (1, 1)),
                              (x, w, b), g)
    for got, want in zip(grads, ref):
        assert _rel_max(got, want) <= 1e-5


def test_disc_conv_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 32, 5, 20, device=cuda)
    w = torch.randn(32, 32, 3, 3, device=cuda)
    with pytest.raises(TypeError):
        dck.disc_conv_forward(x.double(), w.double(), None, (1, 1), (1, 1), (1, 1))
    with pytest.raises(ValueError):
        dck.disc_conv_forward(x, w, None, (2, 1), (1, 1), (1, 1))
    with pytest.raises(ValueError):
        dck.disc_conv_forward(x.transpose(2, 3), w, None, (1, 1), (1, 1), (1, 1))
    with pytest.raises(ValueError):     # taps the kernel is not built for
        dck.disc_conv_forward(x, w[..., :2], None, (1, 1), (1, 1), (1, 1))


@pytest.mark.parametrize('B,T,F,dt', [(2, 11, 57, 1), (1, 21, 33, 2), (3, 9, 70, 4),
                                      (1, 40, 129, 4), (2, 8, 17, 1)])
def test_disc_im2col_kernel_matches_plain(cuda, B, T, F, dt):
    """K5 against its plain version (the im2col GEMM) and cuDNN's conv, at
    ragged T and F tiles, T shorter than the dilated window, and every T
    dilation of the discriminator."""
    gen = torch.Generator(device=cuda).manual_seed(B * T + F + dt)
    x = torch.randn(B, 32, T, F, generator=gen, device=cuda)
    w = torch.randn(32, 32, 3, 9, generator=gen, device=cuda) / 30
    b = torch.randn(32, generator=gen, device=cuda)
    geo = ((dt, 1), (dt, 4))
    launches = k5.disc_im2col_forward.launches
    y = k5.disc_im2col_forward(x, w, b, *geo)
    assert k5.disc_im2col_forward.launches == launches + 1
    assert _rel_max(y, k5.disc_im2col_forward_plain(x, w, b, *geo)) <= 1e-5
    ref = torch.nn.functional.conv2d(x, w, b, (1, 2), (dt, 4), (dt, 1))
    assert y.shape == ref.shape and _rel_max(y, ref) <= 1e-5
    assert torch.equal(y, k5.disc_im2col_forward(x, w, b, *geo))


@pytest.mark.parametrize('T,F,dt', [(64, 513, 1), (40, 257, 4)])
def test_disc_im2col_kernel_holds_float64_without_a_bias(cuda, T, F, dt):
    """K5 against the float64 conv at a discriminator shape (the input a
    leaky ReLU's): within 1e-6 by relative norm and no drift of the outputs
    toward zero. Its products summed onto the running sum inside the tensor
    core put the outputs 2e-6 to 6e-6 from float64, every one shrunk, before
    each k-step was summed from zero and added by a rounding f32 add."""
    gen = torch.Generator(device=cuda).manual_seed(T + F + dt)
    x = torch.nn.functional.leaky_relu(torch.randn(4, 32, T, F, generator=gen, device=cuda), 0.2)
    w = torch.randn(32, 32, 3, 9, generator=gen, device=cuda) / (32 * 27) ** 0.5
    b = torch.randn(32, generator=gen, device=cuda) * 0.1
    ref = torch.nn.functional.conv2d(x.double(), w.double(), b.double(), (1, 2), (dt, 4),
                                     (dt, 1))
    d = k5.disc_im2col_forward(x, w, b, (dt, 1), (dt, 4)).double() - ref
    assert float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref)) <= 1e-6
    assert abs(float((d * ref.sign()).mean() / ref.abs().mean())) <= 1e-7


@pytest.mark.parametrize('B', [1, 3])
@pytest.mark.parametrize('Fo', [33, 65])
@pytest.mark.parametrize('dt', [1, 2, 4])
def test_disc_im2col_kernel_at_ragged_tiles(cuda, B, Fo, dt):
    """K5 at Fo = 2^k + 1 (one column past the 32-column blocks), T 21 (a
    block of 16 rows and a ragged one), every T dilation: within 1e-5 of max
    of its plain version and of cuDNN, the same bits on a second call, one
    launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(100 * B + Fo + dt)
    x = torch.randn(B, 32, 21, 2 * Fo - 1, generator=gen, device=cuda)
    w = torch.randn(32, 32, 3, 9, generator=gen, device=cuda) / 30
    b = torch.randn(32, generator=gen, device=cuda)
    geo = ((dt, 1), (dt, 4))
    launches = k5.disc_im2col_forward.launches
    y = k5.disc_im2col_forward(x, w, b, *geo)
    again = k5.disc_im2col_forward(x, w, b, *geo)
    assert k5.disc_im2col_forward.launches == launches + 2
    assert y.shape == (B, 32, 21, Fo) and torch.equal(y, again)
    assert _rel_max(y, k5.disc_im2col_forward_plain(x, w, b, *geo)) <= 1e-5
    assert _rel_max(y, torch.nn.functional.conv2d(x, w, b, (1, 2), (dt, 4), (dt, 1))) <= 1e-5


def test_disc_im2col_weight_packing_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(11)
    w = torch.randn(32, 32, 3, 9, generator=gen, device=cuda)
    assert torch.equal(k5.pack_weight_cuda(w), k5.pack_weight(w))


def test_disc_im2col_autograd_matches_plain(cuda):
    """The trainable route: K5 forward, K4 dx and cuDNN's dW."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(2, 32, 13, 41, generator=gen, device=cuda, requires_grad=True)
    w = (torch.randn(32, 32, 3, 9, generator=gen, device=cuda) / 30).requires_grad_()
    b = torch.randn(32, generator=gen, device=cuda, requires_grad=True)
    g = torch.randn(2, 32, 13, 21, generator=gen, device=cuda)
    launches = k5.disc_im2col_forward.launches, dck.disc_conv_input_grad.launches
    grads = torch.autograd.grad(k5.disc_im2col(x, w, b, (2, 1), (2, 4)), (x, w, b), g)
    assert (k5.disc_im2col_forward.launches, dck.disc_conv_input_grad.launches) == (
        launches[0] + 1, launches[1] + 1)
    ref = torch.autograd.grad(torch.nn.functional.conv2d(x, w, b, (1, 2), (2, 4), (2, 1)),
                              (x, w, b), g)
    for got, want in zip(grads, ref):
        assert _rel_max(got, want) <= 1e-5


def test_disc_im2col_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 32, 5, 20, device=cuda)
    w = torch.randn(32, 32, 3, 9, device=cuda)
    with pytest.raises(TypeError):
        k5.disc_im2col_forward(x.double(), w.double(), None, (1, 1), (1, 4))
    with pytest.raises(ValueError):
        k5.disc_im2col_forward(x.transpose(2, 3), w, None, (1, 1), (1, 4))
    with pytest.raises(ValueError):     # channels the kernel is not built for
        k5.disc_im2col_forward(x[:, :16], w[:16, :16], None, (1, 1), (1, 4))
    with pytest.raises(ValueError):
        k5.disc_im2col_forward(x, w, None, (1, 2), (1, 4))
    with pytest.raises(ValueError):     # a T dilation the bf16 kernel is not built for
        k5.disc_im2col_forward(x.bfloat16(), w.bfloat16(), None, (3, 1), (3, 4))


def _bf16_matches(got, ref):
    """A bf16 kernel against its plain version: >= 99 % bit-equal, the rest
    within 1 bf16 ulp or, where the sum nearly cancels, 1e-5 of max|ref|."""
    agree = chip_smoke.bf16_agreement(torch, got, ref)
    assert chip_smoke.bf16_ok(agree), agree


# the bf16 kernel's persistent grid: a tile count that the grid does not
# divide (510 forward tiles of 32 rows x 16 columns, 990 dx tiles of 32 rows
# x 8 columns in both phases) with the last column block ragged, and fewer
# tiles than SMs; then more channels than a CTA keeps resident, so that the
# weights stream chunk by chunk (the 3x9 forward and its dx at 64 channels,
# every dilation, a 96 -> 48 conv whose dx sums 48), and conv_4 at 64
BF16_EDGE_CASES = [
    (3, 32, 32, 300, 513, (3, 9), (1, 2), (1, 1), (1, 4)),
    (1, 32, 32, 5, 33, (3, 3), (1, 1), (2, 1), (2, 1)),
    (2, 64, 64, 21, 129, (3, 9), (1, 2), (1, 1), (1, 4)),
    (1, 64, 64, 37, 257, (3, 9), (1, 2), (2, 1), (2, 4)),
    (1, 64, 64, 19, 65, (3, 9), (1, 2), (4, 1), (4, 4)),
    (1, 96, 48, 11, 57, (3, 9), (1, 2), (2, 1), (2, 4)),
    (2, 64, 64, 13, 41, (3, 3), (1, 1), (1, 1), (1, 1)),
]


@pytest.mark.parametrize('B,Cin,Cout,T,F,k,stride,dilation,padding',
                         DISC_CASES + BF16_EDGE_CASES)
def test_disc_conv_bf16_kernel_matches_plain(cuda, B, Cin, Cout, T, F, k, stride, dilation,
                                             padding):
    """K4's bf16 forward and dx: the conv before the bias held to the plain
    version (the f32 conv of the bf16 operands, rounded), the bias added after
    the rounding bit-exactly, one bf16 launch each and no f32 one."""
    gen = torch.Generator(device=cuda).manual_seed(T * F + Cin + 1)
    bf = torch.bfloat16
    x = torch.randn(B, Cin, T, F, generator=gen, device=cuda).to(bf)
    w = (torch.randn(Cout, Cin, *k, generator=gen, device=cuda)
         / (Cin * k[0] * k[1]) ** 0.5).to(bf)
    b = torch.randn(Cout, generator=gen, device=cuda).to(bf)
    counts = (dck.disc_conv_forward.launches, dck.disc_conv_forward_bf16.launches)
    conv = dck.disc_conv_forward(x, w, None, stride, dilation, padding)
    y = dck.disc_conv_forward(x, w, b, stride, dilation, padding)
    assert (dck.disc_conv_forward.launches, dck.disc_conv_forward_bf16.launches) == (
        counts[0], counts[1] + 2)
    assert y.dtype == bf and torch.equal(y, conv + b.reshape(1, -1, 1, 1))
    _bf16_matches(conv, dck.disc_conv_forward_reference(x, w, None, stride, dilation, padding))
    g = torch.randn(y.shape, generator=gen, device=cuda).to(bf)
    dx = dck.disc_conv_input_grad(g, w, x.shape, stride, dilation, padding)
    assert dx.dtype == bf
    _bf16_matches(dx, dck.disc_conv_input_grad_reference(g, w, x.shape, stride, dilation,
                                                         padding))
    assert torch.equal(dx, dck.disc_conv_input_grad(g, w, x.shape, stride, dilation, padding))


@pytest.mark.parametrize('Cout,Cin,k,sf', [(32, 32, (3, 9), 2), (32, 32, (3, 3), 1),
                                            (64, 40, (3, 9), 2), (40, 36, (3, 3), 1)])
def test_bf16_pack_kernels_are_the_plain_packings(cuda, Cout, Cin, k, sf):
    gen = torch.Generator(device=cuda).manual_seed(Cout + Cin + 1)
    w = torch.randn(Cout, Cin, *k, generator=gen, device=cuda).to(torch.bfloat16)
    assert torch.equal(dck.pack_weight_cuda(w, sf, dx=False),
                       dck.pack_weight_bf16(w.permute(1, 2, 3, 0)[None], sf))
    assert torch.equal(dck.pack_weight_cuda(w, sf, dx=True),
                       dck.pack_weight_bf16(dck.pack_dx_weight(w, sf), 1))
    if (Cout, Cin, k) == (32, 32, (3, 9)):
        assert torch.equal(k5.pack_weight_cuda(w), k5.pack_weight_bf16(w))


# the (T, F, dilation) of the 9 F-stride-2 convs of the 48 kHz discriminator
K5_SHAPES_48K = [(184, 513, 1), (184, 257, 2), (184, 129, 4), (90, 1025, 1), (90, 513, 2),
                 (90, 257, 4), (372, 257, 1), (372, 129, 2), (372, 65, 4)]
# K5 bf16's persistent grid (tiles of 32 rows x 16 columns): ragged tiles at
# every dilation (T 21); a tile count the grid does not divide (3 x 10 x 17 =
# 510) with a ragged last column block; fewer tiles than SMs; To one below and
# at a tile's 32 rows, and one past; Fo = 2^k + 1 for k = 4 to 9; the 48 kHz
# call's 9 shapes at B 2
K5_BF16_CASES = ([(B, 21, Fo, dt) for B in (1, 3) for Fo in (33, 65) for dt in (1, 2, 4)]
                 + [(3, 300, 257, 1), (1, 8, 17, 4), (1, 31, 65, 2), (2, 32, 65, 4),
                    (1, 33, 129, 1), (1, 24, 17, 1), (1, 40, 257, 2), (1, 10, 513, 4)]
                 + [(2, T, (F - 1) // 2 + 1, dt) for T, F, dt in K5_SHAPES_48K])


@pytest.mark.parametrize('B,T,Fo,dt', K5_BF16_CASES)
def test_disc_im2col_bf16_kernel_matches_plain(cuda, B, T, Fo, dt):
    """K5's bf16 form at ragged tiles and every T dilation, and at what only a
    persistent grid can get wrong: held to its plain version and, by the same
    rule, to K4's bf16 forward (the two sum their k steps in different
    orders), the same bits on a repeat."""
    gen = torch.Generator(device=cuda).manual_seed(100 * B + Fo + dt + 1
                                                   + (0 if T == 21 else 100_000 * T))
    bf = torch.bfloat16
    x = torch.randn(B, 32, T, 2 * Fo - 1, generator=gen, device=cuda).to(bf)
    w = (torch.randn(32, 32, 3, 9, generator=gen, device=cuda) / 30).to(bf)
    b = torch.randn(32, generator=gen, device=cuda).to(bf)
    geo = ((dt, 1), (dt, 4))
    counts = (k5.disc_im2col_forward.launches, k5.disc_im2col_forward_bf16.launches)
    conv = k5.disc_im2col_forward(x, w, None, *geo)
    y = k5.disc_im2col_forward(x, w, b, *geo)
    assert (k5.disc_im2col_forward.launches, k5.disc_im2col_forward_bf16.launches) == (
        counts[0], counts[1] + 2)
    assert y.shape == (B, 32, T, Fo) and torch.equal(y, conv + b.reshape(1, -1, 1, 1))
    _bf16_matches(conv, k5.disc_im2col_forward_plain(x, w, None, *geo))
    _bf16_matches(dck.disc_conv_forward_bf16(x, w, None, k5.STRIDE, *geo), conv)
    assert torch.equal(y, k5.disc_im2col_forward(x, w, b, *geo))


def test_bf16_autograd_routes_take_the_bf16_kernels(cuda):
    """A bf16 conv through K4's and K5's trainable routes launches the bf16
    kernels (forward and dx) and never their f32 forms; the gradients reach
    f32 master weights through the cast, finite."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(2, 32, 13, 41, generator=gen, device=cuda, requires_grad=True)
    w = (torch.randn(32, 32, 3, 9, generator=gen, device=cuda) / 30).requires_grad_()
    b = torch.randn(32, generator=gen, device=cuda, requires_grad=True)
    entries = (dck.disc_conv_forward, dck.disc_conv_input_grad, k5.disc_im2col_forward,
               dck.disc_conv_forward_bf16, dck.disc_conv_input_grad_bf16,
               k5.disc_im2col_forward_bf16)
    before = [fn.launches for fn in entries]
    bf = torch.bfloat16
    y1 = dck.disc_conv(x.to(bf), w.to(bf), b.to(bf), (1, 2), (1, 1), (1, 4))
    y2 = k5.disc_im2col(x.to(bf), w.to(bf), b.to(bf), (2, 1), (2, 4))
    grads = torch.autograd.grad((y1.float().square().mean() + y2.float().square().mean()),
                                (x, w, b))
    assert [fn.launches - n for fn, n in zip(entries, before)] == [0, 0, 0, 1, 2, 1]
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_bf16_wrappers_reject_other_dtypes(cuda):
    x = torch.randn(1, 32, 5, 20, device=cuda)
    w = torch.randn(32, 32, 3, 9, device=cuda)
    with pytest.raises(TypeError):
        dck.disc_conv_forward(x.half(), w.half(), None, (1, 2), (1, 1), (1, 4))
    with pytest.raises(TypeError):         # one dtype for all inputs
        dck.disc_conv_forward(x.bfloat16(), w, None, (1, 2), (1, 1), (1, 4))
    with pytest.raises(TypeError):
        dck.disc_conv_forward_bf16(x, w, None, (1, 2), (1, 1), (1, 4))
    with pytest.raises(TypeError):
        k5.disc_im2col_forward(x.bfloat16(), w, None, (1, 1), (1, 4))
    with pytest.raises(TypeError):
        k5.disc_im2col_forward_bf16(x.half(), w.half(), None, (1, 1), (1, 4))


def test_segmented_model_on_the_card(cuda):
    """A 48 kHz-architecture model (``time_group_norm``) on the card: its
    resblocks never take K3, and its codes and audio match the same model on
    the CPU."""
    model = EncodecModel._get_model([3., 6.], 48000, 2, causal=False,
                                    model_norm='time_group_norm', audio_normalize=True,
                                    segment=0.05, n_q=4, n_filters=8,
                                    generator=torch.Generator().manual_seed(4)).eval()
    gen = torch.Generator().manual_seed(5)
    for layer in model.quantizer.vq.layers:
        layer._codebook.embed.normal_(generator=gen)
    model.set_target_bandwidth(6.)
    x = torch.randn(2, 2, 6000, generator=gen) * 0.1
    ref = model.encode(x)
    ref_wav = model.decode(ref)
    model.cuda()
    launches = resblock_kernel.resblock.launches
    got = model.encode(x.cuda())
    wav = model.decode(got)
    assert resblock_kernel.resblock.launches == launches
    for (c, s), (rc, rs) in zip(got, ref):
        assert float((c.cpu() == rc).float().mean()) >= 0.99
        assert _rel_max(s.cpu(), rs) <= 1e-5
    assert _rel_max(wav.cpu(), ref_wav) <= 1e-3


def test_lstm_autograd_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    xp = torch.randn(30, 3, 4 * 64, generator=gen, device=cuda, requires_grad=True)
    w_hh = (torch.randn(4 * 64, 64, generator=gen, device=cuda) / 8).requires_grad_()
    g = torch.randn(30, 3, 64, generator=gen, device=cuda)
    got = torch.autograd.grad(lstm.recurrence(xp, w_hh), (xp, w_hh), g)
    ref = torch.autograd.grad(lstm_kernel.lstm_recurrence_reference(xp, w_hh)[0], (xp, w_hh), g)
    for a, b in zip(got, ref):
        assert _rel_max(a, b) <= 1e-5


def _cuda_trainer(tmp_path, *overrides):
    """A tiny trainer on the card (generator n_filters 4, n_q 4, weight norm,
    pinned to float32: its eval forward runs K1, K2 and K3, which bf16
    blocks do not take; discriminator at its full 32 filters, so that its
    eligible convs run K4)."""
    import numpy as np

    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.train.trainer import Trainer
    from encodec_pytorch_tpu_torch.utils import write_wav
    rng = np.random.default_rng(12)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f'{i}.wav'))
        write_wav(paths[-1], rng.uniform(-0.3, 0.3, (1, 4800)).astype(np.float32), 24000)
    (tmp_path / 'data.csv').write_text('\n'.join(paths) + '\n')
    return Trainer(load_config([
        f'datasets.train_csv_path={tmp_path / "data.csv"}',
        f'datasets.test_csv_path={tmp_path / "data.csv"}', 'datasets.tensor_cut=2400',
        'datasets.batch_size=2', 'common.max_epoch=2', 'model.n_filters=4', 'model.n_q=4',
        'model.disc_n_ffts=[512,256]', 'model.disc_hop_lengths=[128,64]',
        'model.disc_win_lengths=[512,256]', 'lr_scheduler.warmup_epoch=0',
        'tpu.compute_dtype=float32', f'checkpoint.save_folder={tmp_path}/', *overrides]),
        device='cuda')


def test_guarded_accumulating_trainer_on_the_card(cuda, tmp_path):
    """The trainer with ``tpu.skip_nonfinite_steps`` and
    ``tpu.grad_accum_steps=2`` on the card, in bf16: Adam keeps its step
    counts on the card (``capturable``, so the guard reverts them without a
    sync), an epoch trains, and no step is dropped."""
    trainer = _cuda_trainer(tmp_path, 'tpu.compute_dtype=bfloat16',
                            'tpu.skip_nonfinite_steps=true', 'tpu.grad_accum_steps=2')
    summary = trainer.train_one_epoch(1)
    assert summary['steps'] == 2 and summary['skipped_nonfinite'] == 0.0
    assert trainer.model.encoder.dtype == torch.bfloat16
    for opt in (trainer.opt_g, trainer.opt_d):
        assert all(s['step'].is_cuda and float(s['step']) == 2 for s in opt.state.values())


def test_checkpoint_round_trip_and_resume_on_the_card(cuda, tmp_path):
    """The snapshot of state on the card (device-to-host copies, one
    synchronize) loads back bit-equal, onto the card, and the resumed
    trainer trains on."""
    from encodec_pytorch_tpu_torch.train import checkpoint
    trainer = _cuda_trainer(tmp_path)
    trainer.train_one_epoch(1)
    path = trainer.save(1)
    trainer.writer.wait_pending()
    want = checkpoint.snapshot(dict(trainer.state_dict(), step=trainer.step))
    state, epoch = checkpoint.load_checkpoint(path)
    assert epoch == 1 and state['step'] == 2
    resumed = _cuda_trainer(tmp_path, 'checkpoint.resume=True',
                            f'checkpoint.checkpoint_path={path}')
    got = checkpoint.snapshot(dict(resumed.state_dict(), step=resumed.step))
    for name in ('model_state_dict', 'disc_state_dict'):
        assert all(v.is_cuda for v in getattr(resumed, 'model' if name[0] == 'm'
                                              else 'disc').state_dict().values())
        for k, v in want[name].items():
            assert torch.equal(got[name][k], v) and torch.equal(state[name][k], v), k
    for name in ('optimizer_g', 'optimizer_d'):
        for i, st in want[name]['state'].items():
            for k, v in st.items():
                assert torch.equal(got[name]['state'][i][k], v), (name, i, k)
    for name in ('host_generator', 'device_generator'):
        assert torch.equal(got[name], want[name])
    summary = resumed.train_one_epoch(2)
    assert resumed.step == 4 and summary['steps'] == 2
    assert all(torch.isfinite(p).all() for p in resumed.model.parameters())


def test_eval_step_kernels_match_plain(cuda, tmp_path):
    """The test loop's step from one trained state through the kernels (K1,
    K2, K3, K4's forward) and through their plain versions: codes >= 99 %
    equal, losses within 1e-3 relative."""
    from encodec_pytorch_tpu_torch.train.step import eval_step
    trainer = _cuda_trainer(tmp_path)
    trainer.train_one_epoch(1)
    model, disc = trainer.model.eval(), trainer.disc.eval()
    batch = torch.from_numpy(next(iter(trainer.testloader))).cuda()
    names = ('rvq_encode', 'lstm_recurrence', 'resblock')
    chip_smoke.reset_counts()
    dck.disc_conv_forward.launches = 0
    got = eval_step(model, disc, batch, 24000)
    codes = model.encode(batch)[0][0]
    counts = chip_smoke.read_counts()
    assert all(counts[k] > 0 for k in names) and dck.disc_conv_forward.launches > 0, counts
    with chip_smoke.plain_path():
        ref = eval_step(model, disc, batch, 24000)
        ref_codes = model.encode(batch)[0][0]
    assert float((codes == ref_codes).float().mean()) >= 0.99
    for k, v in ref.items():
        assert abs(float(got[k]) - float(v)) <= 1e-3 * abs(float(v)), k


def test_folded_bytes_equal_raw_on_the_card(cuda):
    """``.ecdc`` bytes of a weight-norm model folded on the card equal the
    raw model's, and both run K3."""
    import numpy as np

    from encodec_pytorch_tpu_torch import compress
    from encodec_pytorch_tpu_torch.prepare import fold_weight_norm
    model = EncodecModel._get_model([1.5, 3., 6.], 24000, 1, causal=True, n_q=8,
                                    n_filters=8, name='encodec_24khz',
                                    generator=torch.Generator().manual_seed(7)).eval()
    gen = torch.Generator().manual_seed(8)
    for layer in model.quantizer.vq.layers:
        layer._codebook.embed.normal_(generator=gen)
    model = model.cuda()
    model.set_target_bandwidth(6.)
    folded = fold_weight_norm(model)
    wav = (np.random.default_rng(9).standard_normal((1, 24000)) * 0.1).astype(np.float32)
    launches = resblock_kernel.resblock.launches
    raw = compress.compress(model, wav)
    mid = resblock_kernel.resblock.launches
    assert compress.compress(folded, wav) == raw
    assert mid > launches and resblock_kernel.resblock.launches > mid


def _lm_coder_case(K, card, steps, seed, alpha=0.25):
    import numpy as np
    rng = np.random.default_rng(seed)
    pdfs = rng.dirichlet(np.full(card, alpha), size=(steps, K)).astype(np.float32)
    syms = np.array([[rng.choice(card, p=p / p.sum()) for p in row] for row in pdfs], np.int32)
    return pdfs, syms


def _lm_edge_case(card=64):
    import numpy as np
    pdfs, syms = [], []
    for i in range(60):
        p = np.full(card, 1e-9, np.float32)
        p[i % card] = 1.0
        pdfs.append(p / p.sum())
        syms.append([0, card - 1, i % card][i % 3])
    pdfs.append(np.full(card, 1.0 / card, np.float32))
    syms.append(card // 2)
    return np.stack(pdfs)[:, None].astype(np.float32), np.asarray(syms, np.int32)[:, None]


def _lm_host_bytes(pdfs, syms):
    from encodec_pytorch_tpu_torch.bitstream import native
    enc = native.NativeAcEncoder(24)
    flat = pdfs.reshape(-1, pdfs.shape[-1])
    enc.push_batch(syms.reshape(-1), native.build_cdf_batch(flat))
    return enc.finish()


def _lm_kernel_encode(pdfs, syms, device):
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    steps, K, _ = pdfs.shape
    coder = k6.init_state(device)
    bits = torch.zeros(k6.stream_bytes(k6.bits_capacity(steps * K)), dtype=torch.uint8,
                       device=device)
    k6.lm_coder(torch.from_numpy(pdfs).to(device), torch.from_numpy(syms).to(device), coder,
                bits, decode=False, finish=True)
    coder = coder.cpu()
    assert coder[k6.OVERFLOW] == 0
    return bits[:k6.stream_bytes(int(coder[k6.BIT_POS]))].cpu().numpy().tobytes()


def _lm_kernel_decode(data, pdfs, device):
    """One launch a step, as the fused decoder launches it."""
    import numpy as np

    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    steps, K, _ = pdfs.shape
    buf = np.zeros(k6.stream_bytes(k6.bits_capacity(steps * K)), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)[:buf.size]
    bits = torch.from_numpy(buf).to(device)
    coder = k6.init_state(device)
    syms = torch.zeros(steps, K, dtype=torch.int32, device=device)
    p = torch.from_numpy(pdfs).to(device)
    for t in range(steps):
        k6.lm_coder(p[t:t + 1], syms[t:t + 1], coder, bits, decode=True, n_bits_in=8 * len(data))
    return syms.cpu().numpy(), int(coder[k6.OVERRUN])


@pytest.mark.parametrize('K,card,steps', [(4, 1024, 40), (8, 1024, 30), (32, 1024, 12),
                                          (3, 200, 25), (5, 16, 20), (3, 4096, 10)])
def test_lm_coder_kernel_matches_plain_and_host(cuda, K, card, steps):
    """K6's bytes equal its plain version's and the host coder's; decode
    returns the symbols; its CDFs equal the host build bit for bit."""
    import numpy as np

    from encodec_pytorch_tpu_torch.bitstream import native
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    pdfs, syms = _lm_coder_case(K, card, steps, seed=K * card + steps)
    host = _lm_host_bytes(pdfs, syms)
    launches = k6.lm_coder.launches
    assert _lm_kernel_encode(pdfs, syms, cuda) == host
    assert k6.lm_coder.launches == launches + 1
    assert _lm_kernel_encode(pdfs, syms, torch.device('cpu')) == host     # the plain version
    got, overrun = _lm_kernel_decode(host, pdfs, cuda)
    np.testing.assert_array_equal(got, syms)
    assert overrun == 0
    cdf = k6.build_cdf(torch.from_numpy(pdfs).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(cdf.reshape(-1, card),
                                  native.build_cdf_batch(pdfs.reshape(-1, card)))


def test_lm_coder_kernel_edge_pdfs_and_overrun(cuda):
    """One-hot pdfs with the symbols at both edges and on the hot bin, and a
    uniform pdf; then a truncated stream sets ``overrun``, and a symbol
    outside the card ``overflow``."""
    import numpy as np
    pdfs, syms = _lm_edge_case()
    host = _lm_host_bytes(pdfs, syms)
    assert _lm_kernel_encode(pdfs, syms, cuda) == host
    got, overrun = _lm_kernel_decode(host, pdfs, cuda)
    np.testing.assert_array_equal(got, syms)
    assert overrun == 0
    pdfs, syms = _lm_coder_case(8, 1024, 20, seed=5)
    host = _lm_host_bytes(pdfs, syms)
    _, overrun = _lm_kernel_decode(host[:len(host) // 3], pdfs, cuda)
    assert overrun == 1
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    syms[3, 2] = 1024      # outside the card: flagged, as the plain version flags it
    for device in (cuda, torch.device('cpu')):
        coder = k6.init_state(device)
        bits = torch.zeros(k6.stream_bytes(k6.bits_capacity(syms.size)), dtype=torch.uint8,
                           device=device)
        k6.lm_coder(torch.from_numpy(pdfs).to(device), torch.from_numpy(syms).to(device), coder,
                    bits, decode=False, finish=True)
        assert int(coder[k6.OVERFLOW]) == 1


def test_fused_lm_coder_on_the_card(cuda, monkeypatch):
    """The on-device coder with a small LM on the card: codes round-trip with
    no host sync inside either step loop, encoding in chunks of steps gives
    the bytes of one launch, a truncated stream raises EOFError, and the
    streams on the card decode on the card."""
    import numpy as np

    from encodec_pytorch_tpu_torch.bitstream import fused
    from encodec_pytorch_tpu_torch.models.lm import LMModel
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    torch.manual_seed(0)
    lm = LMModel(n_q=8, card=1024, dim=64, num_heads=8, num_layers=2, past_context=20).eval()
    coder = fused.FusedLmCoder(lm.to(cuda))
    codes = np.random.default_rng(1).integers(0, 1024, (8, 57))
    data = coder.encode(codes)
    np.testing.assert_array_equal(coder.decode(data, 8, 57), codes)
    K, T = codes.shape
    inputs = torch.zeros(T, K, dtype=torch.int64, device=cuda)
    inputs[1:] = 1 + torch.from_numpy(codes.T[:-1]).to(cuda)
    syms = torch.from_numpy(np.ascontiguousarray(codes.T, np.int32)).to(cuda)
    bits = torch.zeros(k6.stream_bytes(k6.bits_capacity(K * T)), dtype=torch.uint8, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        state = coder.encode_steps(inputs, syms, bits)
        chunked = torch.zeros_like(bits)
        monkeypatch.setattr(fused, 'ENCODE_CHUNK', 20)
        coder.encode_steps(inputs, syms, chunked)
        out, dec_state = coder.decode_steps(bits.clone(), 8 * len(data), K, T)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert bits[:len(data)].cpu().numpy().tobytes() == data
    assert torch.equal(chunked, bits)
    assert int(state[k6.BIT_POS].cpu()) <= 8 * len(data)
    np.testing.assert_array_equal(out.t().cpu().numpy(), codes)
    with pytest.raises(EOFError):
        coder.decode(data[:len(data) // 4], 8, 57)


def _stream_buffer(data, n_symbols, device):
    import numpy as np

    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    buf = np.zeros(k6.stream_bytes(k6.bits_capacity(n_symbols)), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(buf).to(device)


@pytest.mark.parametrize('card', [16, 1024, 4096])
@pytest.mark.parametrize('K', [4, 8, 32])
def test_lm_coder_stall_mode_matches_plain(cuda, K, card):
    """K6's stall mode against its plain version on the same inputs: from the
    state before each of 4 steps, the stream cut at its start, one bit on,
    halfway, one bit before its end, at it and past it. The symbols written
    before a stall, the whole state and the stall decision are equal, and
    the cuts stall at the first symbol, in mid-step and never."""
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    pdfs, syms = _lm_coder_case(K, card, 4, seed=3 * K + card)
    data = _lm_host_bytes(pdfs, syms)
    bits = _stream_buffer(data, syms.size, 'cpu')
    bits_cuda = bits.to(cuda)
    p, p_cuda = torch.from_numpy(pdfs), torch.from_numpy(pdfs).to(cuda)
    state, seen = k6.init_state(), set()
    for t in range(4):
        after = state.clone()
        k6.lm_coder_reference(p[t:t + 1], torch.zeros(1, K, dtype=torch.int32), after, bits,
                              decode=True, n_bits_in=8 * len(data))
        start, end = int(state[k6.BIT_POS]), int(after[k6.BIT_POS])
        for n in sorted({start, start + 1, (start + end) // 2, end - 1, end, end + 1}):
            got_syms = torch.full((1, K), -1, dtype=torch.int32, device=cuda)
            got_state = state.to(cuda)
            k6.lm_coder(p_cuda[t:t + 1], got_syms, got_state, bits_cuda, decode=True,
                        n_bits_in=n, stall=True)
            want_syms, want_state = torch.full((1, K), -1, dtype=torch.int32), state.clone()
            k6.lm_coder_reference(p[t:t + 1], want_syms, want_state, bits, decode=True,
                                  n_bits_in=n, stall=True)
            assert torch.equal(got_syms.cpu(), want_syms), (t, n)
            assert torch.equal(got_state.cpu(), want_state), (t, n)
            decoded = int((want_syms >= 0).sum())
            seen.add('never' if not want_state[k6.STALLED] else 'first' if decoded == 0
                     else 'mid')
        state = after
    assert seen == {'first', 'mid', 'never'}


@pytest.mark.parametrize('K,steps,finish', [(8, 1, False), (32, 1, False), (32, 3, True),
                                            (8, 0, True)])
def test_lm_coder_encode_on_a_rebased_buffer(cuda, K, steps, finish):
    """An encode on a buffer rebased as ``StreamingLmEncoder.push_frame``
    rebases it (the cursor restarted at n_bits % 8 != 0, the partial byte
    kept at the front, the rest zero): one launch for 8 and 32 symbols, two
    for 96, and the flush alone. Its bytes and state equal the plain
    version's on the same buffer and state."""
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    pdfs, syms = _lm_coder_case(K, 1024, 8 + steps, seed=K + steps)
    p, s = torch.from_numpy(pdfs), torch.from_numpy(syms)
    cap = k6.stream_bytes(8 + k6.bits_capacity(K * max(steps, 1)))
    for prefix in range(1, 8):
        state = k6.init_state()
        bits = torch.zeros(k6.stream_bytes(k6.bits_capacity(K * prefix)), dtype=torch.uint8)
        k6.lm_coder_reference(p[:prefix], s[:prefix], state, bits, decode=False)
        n_bits = int(state[k6.BIT_POS])
        if n_bits % 8:
            break
    assert n_bits % 8, 'no prefix ends inside a byte'
    rebased = torch.zeros(cap, dtype=torch.uint8)
    rebased[0] = bits[n_bits // 8]
    state[k6.BIT_POS] = n_bits % 8
    chunk = slice(prefix, prefix + steps)
    got_state, got_bits = state.to(cuda), rebased.to(cuda)
    k6.lm_coder(p[chunk].contiguous().to(cuda), s[chunk].contiguous().to(cuda), got_state,
                got_bits, decode=False, finish=finish)
    want_state, want_bits = state.clone(), rebased.clone()
    k6.lm_coder_reference(p[chunk], s[chunk], want_state, want_bits, decode=False,
                          finish=finish)
    assert torch.equal(got_bits.cpu(), want_bits)
    assert torch.equal(got_state.cpu(), want_state)
    assert int(want_state[k6.BIT_POS]) > n_bits % 8


@pytest.mark.parametrize('chunk', [1, 3, 8, 9, 100])
def test_lm_coder_encode_in_chunks_gives_one_calls_bytes(cuda, chunk):
    """200 steps of K 8 encoded in chunks of 1, 3, 8 (64 symbols, one
    launch), 9 (72, two launches) and 100 steps, the last chunk flushing,
    give the bytes of one call and of the host coder."""
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    pdfs, syms = _lm_coder_case(8, 1024, 200, seed=11)
    host = _lm_host_bytes(pdfs, syms)
    assert _lm_kernel_encode(pdfs, syms, cuda) == host
    p, s = torch.from_numpy(pdfs).to(cuda), torch.from_numpy(syms).to(cuda)
    state = k6.init_state(cuda)
    bits = torch.zeros(k6.stream_bytes(k6.bits_capacity(syms.size)), dtype=torch.uint8,
                       device=cuda)
    for t0 in range(0, 200, chunk):
        k6.lm_coder(p[t0:t0 + chunk], s[t0:t0 + chunk], state, bits, decode=False,
                    finish=t0 + chunk >= 200)
    n = int(state[k6.BIT_POS])
    assert bits[:k6.stream_bytes(n)].cpu().numpy().tobytes() == host


@pytest.mark.parametrize('K,card,steps', [(32, 1024, 4), (32, 4096, 3), (8, 8192, 4),
                                          (3, 200, 30)])
def test_lm_coder_decodes_many_steps_in_one_launch(cuda, K, card, steps):
    """All steps decoded in one launch, more rows than the ring's slots (48
    at card 1024, 12 at 4096, 6 at 8192, 64 at 200) so that the producers
    reuse slots the coder has released: the symbols, and the state of a
    launch a step."""
    import numpy as np

    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    pdfs, syms = _lm_coder_case(K, card, steps, seed=K * steps + card)
    data = _lm_host_bytes(pdfs, syms)
    bits = _stream_buffer(data, syms.size, cuda)
    p = torch.from_numpy(pdfs).to(cuda)
    one_state = k6.init_state(cuda)
    got = torch.zeros(steps, K, dtype=torch.int32, device=cuda)
    k6.lm_coder(p, got, one_state, bits, decode=True, n_bits_in=8 * len(data))
    np.testing.assert_array_equal(got.cpu().numpy(), syms)
    step_state = k6.init_state(cuda)
    out = torch.zeros(1, K, dtype=torch.int32, device=cuda)
    for t in range(steps):
        k6.lm_coder(p[t:t + 1], out, step_state, bits, decode=True, n_bits_in=8 * len(data))
    assert torch.equal(one_state, step_state)


def _lm_off_range_case(kind, K, card, steps, seed):
    """Inputs that take K6's decoder off its 32-bit narrow step: pdfs [steps,
    K, card] with every odd step's rows scaled by 0.5 (a CDF ending near
    2^23, so that stream bits fall past the last symbol's range) and, for
    ``odd_pdfs``, bins of -0.0, -0.25, 1.5, 3.0 and NaN in every third row (a
    CDF that does not rise); the stream a buffer of random bytes
    (``random_bytes``, ``odd_pdfs``) or the plain encode of drawn symbols
    cut to its first third, ones after it (``cut``: the bits past
    ``n_bits_in`` are read all the same, and ``overrun`` is set) → (pdfs,
    bits, n_bits_in)."""
    import numpy as np

    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    pdfs, syms = _lm_coder_case(K, card, steps, seed)
    pdfs[1::2] *= np.float32(0.5)
    rng = np.random.default_rng(seed + 1)
    if kind == 'odd_pdfs':
        odd = np.float32([-0.0, -0.25, 1.5, 3.0, np.nan])
        for row in pdfs.reshape(-1, card)[::3]:
            row[rng.choice(card, min(card, 5), replace=False)] = odd[:min(card, 5)]
    size = k6.stream_bytes(k6.bits_capacity(steps * K))
    if kind == 'cut':
        state, bits = k6.init_state(), torch.zeros(size, dtype=torch.uint8)
        k6.lm_coder_reference(torch.from_numpy(pdfs), torch.from_numpy(syms), state, bits,
                              decode=False, finish=True)
        kept = k6.stream_bytes(int(state[k6.BIT_POS])) // 3
        bits[kept:] = 255
        return pdfs, bits, 8 * kept
    return pdfs, torch.from_numpy(rng.integers(0, 256, size, dtype=np.uint8)), 8 * size


def _lm_symbols_off_the_narrow_step(pdfs, bits, n_bits_in):
    """The symbols of a decode whose state or row fails the entry of K6's
    narrow step (t = current - low < delta = high - low + 1 <= 2^25, and
    every range of the row in [1, 2^25]), so that the kernel codes them by
    its wide step: the plain version stepped a symbol at a time."""
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    m64 = (1 << 64) - 1
    cdf = k6.build_cdf_reference(pdfs)
    ranges = torch.diff(cdf, dim=-1, prepend=torch.zeros_like(cdf[..., :1]))
    rises = ((ranges >= 1) & (ranges <= 2 ** 25)).all(-1)
    state, count = k6.init_state(), 0
    for s in range(pdfs.shape[0]):
        for k in range(pdfs.shape[1]):
            low, high, current = (v & m64 for v in state[:3].tolist())
            delta, t = (high - low + 1) & m64, (current - low) & m64
            count += not (bool(rises[s, k]) and 1 <= delta <= 2 ** 25 and t < delta)
            k6.lm_coder_reference(pdfs[s:s + 1, k:k + 1].contiguous(),
                                  torch.zeros(1, 1, dtype=torch.int32), state, bits, decode=True,
                                  n_bits_in=n_bits_in)
    return count


@pytest.mark.parametrize('K,card', [(8, 1024), (3, 200), (4, 4096)])
@pytest.mark.parametrize('kind', ['random_bytes', 'cut', 'odd_pdfs'])
def test_lm_coder_wide_step_matches_plain(cuda, kind, K, card):
    """K6's wide step (the uint64 form a symbol falls back to) against the
    plain version on inputs that reach it: random bytes, a stream cut short,
    and pdfs with bins outside [0, 1]. A launch a step, all steps in one
    launch and the stall mode a launch a step give the plain version's
    symbols and whole state after every launch; the CDF mode its CDFs."""
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    steps = 10
    pdfs, bits, n_in = _lm_off_range_case(kind, K, card, steps, seed=K * card + len(kind))
    p = torch.from_numpy(pdfs)
    assert _lm_symbols_off_the_narrow_step(p, bits, n_in) > 0
    p_cuda, bits_cuda = p.to(cuda), bits.to(cuda)
    for stall in (False, True):
        got_state, want_state = k6.init_state(cuda), k6.init_state()
        got = torch.full((steps, K), -1, dtype=torch.int32, device=cuda)
        want = torch.full((steps, K), -1, dtype=torch.int32)
        for t in range(steps):
            k6.lm_coder(p_cuda[t:t + 1], got[t:t + 1], got_state, bits_cuda, decode=True,
                        n_bits_in=n_in, stall=stall)
            k6.lm_coder_reference(p[t:t + 1], want[t:t + 1], want_state, bits, decode=True,
                                  n_bits_in=n_in, stall=stall)
            assert torch.equal(got[t].cpu(), want[t]), (stall, t)
            assert torch.equal(got_state.cpu(), want_state), (stall, t)
    one_state = k6.init_state(cuda)
    one = torch.full((steps, K), -1, dtype=torch.int32, device=cuda)
    k6.lm_coder(p_cuda, one, one_state, bits_cuda, decode=True, n_bits_in=n_in)
    want_state = k6.init_state()
    want = torch.full((steps, K), -1, dtype=torch.int32)
    k6.lm_coder_reference(p, want, want_state, bits, decode=True, n_bits_in=n_in)
    assert torch.equal(one.cpu(), want)
    assert torch.equal(one_state.cpu(), want_state)
    assert torch.equal(k6.build_cdf(p_cuda).long().cpu(), k6.build_cdf_reference(p))


def test_lm_coder_rejects_what_the_kernel_does_not_take(cuda):
    """The wrapper raises on a tensor of another dtype, device, shape or
    layout, and on a card past MAX_CARD; the latency-floor launch runs and
    counts no launch of K6."""
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    pdfs = torch.full((1, 4, 64), 1 / 64, device=cuda)
    syms = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    state, bits = k6.init_state(cuda), torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError, match='pdfs'):
        k6.lm_coder(pdfs.double(), syms, state, bits, decode=True)
    with pytest.raises(TypeError, match='syms'):
        k6.lm_coder(pdfs, syms.long(), state, bits, decode=True)
    with pytest.raises(ValueError, match='state on cpu'):
        k6.lm_coder(pdfs, syms, state.cpu(), bits, decode=True)
    with pytest.raises(ValueError, match='contiguous'):
        k6.lm_coder(pdfs[:, :, ::2], syms, state, bits, decode=True)
    with pytest.raises(ValueError, match='do not make'):
        k6.lm_coder(pdfs, syms[:, :3], state, bits, decode=True)
    with pytest.raises(ValueError, match='outside'):
        k6.lm_coder(torch.zeros(1, 1, k6.MAX_CARD + 1, device=cuda), syms[:, :1], state, bits,
                    decode=True)
    with pytest.raises(ValueError, match='are not'):
        k6.lm_coder(pdfs, syms, state[:4], bits, decode=True)
    launches = k6.lm_coder.launches
    for K, card in ((8, 1024), (32, 4096)):
        k6.lm_coder_floor(1, K, card, cuda)
    torch.cuda.synchronize()
    assert k6.lm_coder.launches == launches
