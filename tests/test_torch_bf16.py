"""The port's bfloat16 activation pipeline against the JAX package's, on the CPU.

The same seeded weights (the port's init, carried to JAX by the JAX package's
own converters) and numpy inputs go through both. In bf16 the two frameworks
round in different places (the JAX package sums its narrow convs' taps in
bf16, XLA's CPU convolution rounds as it does; the port's convs sum in f32
and round once), so the comparisons use bf16 tolerances, each stated with the
value it measured on the CPU:

- encoder latents: mean |error| / mean |latent| < 0.05, the gate of
  ``tests/test_bf16.py:13-24`` (measured: port bf16 vs JAX bf16 0.0058, port
  bf16 vs port f32 0.0056);
- discriminator logits and feature maps: relative L2 norm < 2e-2 (measured:
  at most 3.3e-3);
- codec round trip: >= 95 % of codes equal to f32 and decode relative RMS
  < 0.15, the gates of ``tests/test_bf16.py:52-83`` (measured: 1.0 and
  0.0041; and 1.0 of the codes equal to the JAX bf16 codes);
- K4's and K5's bf16 kernels emulated by their index maps (K4: its raw
  pieces, layout, descriptors and B images; K5: its aligned pieces, the
  shift by the row's alignment, the transposed ``stmatrix`` stores into the
  even/odd window, descriptors and B images) against the f32 plain
  versions: within 1e-5 of max;
- the plain versions of K4 (forward, dx) and K5 in bf16 against the JAX
  Pallas kernels in interpret mode on bf16 inputs: >= 99 % of the outputs
  bit-equal and every other within 1 bf16 ulp or, where the sum nearly
  cancels, within 1e-5 of max|ref| (measured: 0.99961-0.99995 bit-equal; 4
  of ~175k outputs over 1 ulp, up to 8 ulps of a near-zero sum, each under
  1e-5 of max).

On the CPU a bf16 conv of the port is the f32 conv of the bf16 operands,
rounded to bf16 (``ops/conv.py`` ``_biased``): torch's CPU bf16 conv1d returns
wrong sums at some strided shapes (16 -> 32 channels, kernel 8, stride 4: a
mean relative error of 1.1 on the CPU), which put the encoder 0.19 off f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu.convert import msstftd_params_from_torch
from encodec_pytorch_tpu.models.model import EncodecModel as JaxModel
from encodec_pytorch_tpu.models.model import variables_from_torch_state_dict
from encodec_pytorch_tpu.models.msstftd import MultiScaleSTFTDiscriminator as JaxDisc
from encodec_pytorch_tpu.ops.pallas_conv2d import conv2d_im2col
from encodec_pytorch_tpu.ops.pallas_conv2d_v2 import conv2d_v2, conv2d_v2_dx
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.models.msstftd import MultiScaleSTFTDiscriminator
from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
from test_torch_disc import rel_norm

torch.set_num_threads(1)

BF16 = torch.bfloat16
MODEL = dict(target_bandwidths=[1.5, 3.], sample_rate=24_000, channels=1, causal=True,
             model_norm='weight_norm', audio_normalize=False, segment=None, n_q=4,
             n_filters=8)
DISC = dict(filters=4, n_ffts=(256, 128), hop_lengths=(64, 32), win_lengths=(256, 128))


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope='module')
def codec():
    """Port models in f32 and bf16 and the JAX models in both, on one set of
    weights: the port's seeded init, with inited random-normal codebooks (the
    recipe of tests/test_bf16.py)."""
    ports = {d: EncodecModel._get_model(generator=torch.Generator().manual_seed(1), dtype=d,
                                        **MODEL) for d in (torch.float32, BF16)}
    embed = np.random.default_rng(2).standard_normal((4, 1024, 128)).astype(np.float32)
    for m in ports.values():
        for k, layer in enumerate(m.quantizer.vq.layers):
            cb = layer._codebook
            cb.inited.fill_(1)
            cb.embed.copy_(torch.from_numpy(embed[k]))
            cb.embed_avg.copy_(torch.from_numpy(embed[k]))
            cb.cluster_size.fill_(1)
        m.eval().set_target_bandwidth(3.)
    jax_models = {d: JaxModel._get_model(dtype=d, **MODEL) for d in (jnp.float32, jnp.bfloat16)}
    for m in jax_models.values():
        m.set_target_bandwidth(3.)
    variables = jax.device_get(variables_from_torch_state_dict(
        jax_models[jnp.float32], _numpy_sd(ports[torch.float32])))
    x = (np.random.default_rng(3).standard_normal((1, 1, 4800)) * 0.3).astype(np.float32)
    return ports, jax_models, variables, x


def _mean_rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).mean() / np.abs(np.asarray(ref)).mean())


def test_bf16_encoder_matches_jax_and_f32(codec):
    ports, jax_models, variables, x = codec
    enc = lambda d: jax_models[d]._enc_apply({'params': variables['params']['encoder']},
                                             jnp.swapaxes(jnp.asarray(x), 1, 2))
    ref16 = np.swapaxes(np.asarray(enc(jnp.bfloat16)), 1, 2)
    with torch.no_grad():
        got = {d: m.encoder(torch.from_numpy(x)) for d, m in ports.items()}
    assert got[BF16].dtype == torch.float32          # the latent boundary is f32
    assert _mean_rel(got[BF16].numpy(), ref16) < 0.05
    assert _mean_rel(got[BF16].numpy(), got[torch.float32].numpy()) < 0.05
    # bf16 is not a no-op: the two pipelines differ from f32
    assert not np.array_equal(got[BF16].numpy(), got[torch.float32].numpy())


def test_bf16_codec_round_trip_keeps_codes(codec):
    ports, jax_models, variables, x = codec
    with torch.no_grad():
        codes = {d: m.encode(torch.from_numpy(x))[0][0] for d, m in ports.items()}
        wavs = {d: m(torch.from_numpy(x)).numpy() for d, m in ports.items()}
    assert (codes[BF16] == codes[torch.float32]).float().mean() >= 0.95
    err = np.sqrt(((wavs[BF16] - wavs[torch.float32]) ** 2).mean())
    assert err / np.sqrt((wavs[torch.float32] ** 2).mean()) < 0.15
    jax16 = np.asarray(jax_models[jnp.bfloat16].encode(variables, jnp.asarray(x))[0][0])
    assert (codes[BF16].numpy() == jax16).mean() >= 0.95


def test_bf16_code_flips_on_fitted_codebooks_match_jax(codec):
    """Codebooks drawn from the model's own residuals (as ``chip_smoke.py``
    seeds them) put codewords at near-equal distances, where the latent's bf16
    rounding flips the choice: the port's bf16 codes then agree with its f32
    codes about as often as the JAX package's bf16 codes agree with its own
    f32 ones (measured: 0.60 and 0.65 over 4 stages; bound: below 0.95, and
    within 0.1 of each other). The flips are the bf16 pipeline's, not the
    port's."""
    ports, jax_models, variables, x = codec
    gen = torch.Generator().manual_seed(6)
    fitted = {k: v.clone() for k, v in ports[torch.float32].state_dict().items()}
    with torch.no_grad():
        z = ports[torch.float32].encoder(torch.from_numpy(x[..., ::-1].copy()))
        residual = z.transpose(1, 2).reshape(-1, z.shape[1])
        for k in range(4):
            pick = torch.randint(residual.shape[0], (1024,), generator=gen)
            embed = residual[pick] + 0.05 * residual.std() * torch.randn(1024, 128, generator=gen)
            fitted[f'quantizer.vq.layers.{k}._codebook.embed'] = embed
            idx = torch.argmax(2 * residual @ embed.t() - (embed ** 2).sum(-1), -1)
            residual = residual - embed[idx]
    models = {d: EncodecModel._get_model(dtype=d, **MODEL) for d in (torch.float32, BF16)}
    for m in models.values():
        m.load_state_dict(fitted)
        m.eval().set_target_bandwidth(3.)
    with torch.no_grad():
        port = {d: m.encode(torch.from_numpy(x))[0][0].numpy() for d, m in models.items()}
    jv = jax.device_get(variables_from_torch_state_dict(
        jax_models[jnp.float32], {k: v.numpy() for k, v in fitted.items()}))
    ref = {d: np.asarray(m.encode(jv, jnp.asarray(x))[0][0]) for d, m in jax_models.items()}
    np.testing.assert_array_equal(port[torch.float32], ref[jnp.float32])
    port_agree = (port[BF16] == port[torch.float32]).mean()
    jax_agree = (ref[jnp.bfloat16] == ref[jnp.float32]).mean()
    assert port_agree < 0.95 and abs(port_agree - jax_agree) < 0.1, (port_agree, jax_agree)


@pytest.fixture(scope='module')
def discs():
    port = MultiScaleSTFTDiscriminator(generator=torch.Generator().manual_seed(4), dtype=BF16,
                                       **DISC)
    jd = JaxDisc(fpack=0, dtype=jnp.bfloat16, **DISC)
    params = jax.device_get(msstftd_params_from_torch(_numpy_sd(port)))
    return port, jd, params


def test_bf16_disc_matches_jax_and_is_differentiable(discs):
    port, jd, params = discs
    x = (np.random.default_rng(5).standard_normal((2, 1, 2048)) * 0.3).astype(np.float32)
    ref_logits, ref_fmaps = jax.jit(jd.apply)({'params': params}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    logits, fmaps = port(xt)
    for got, ref in zip(logits, ref_logits):
        assert got.dtype == torch.float32                 # the loss boundary is f32
        rel_norm(got.detach().numpy(), np.moveaxis(np.asarray(ref), -1, 1), rel=2e-2)
    for fm, ref_fm in zip(fmaps, ref_fmaps):
        for got, ref in zip(fm, ref_fm):
            assert got.dtype == torch.float32
            rel_norm(got.detach().numpy(), np.moveaxis(np.asarray(ref), -1, 1), rel=2e-2)
    loss = sum(torch.relu(1 - lg).mean() for lg in logits) + sum(
        f.abs().mean() for fm in fmaps for f in fm)
    (grad,) = torch.autograd.grad(loss, xt)
    assert grad.dtype == torch.float32 and torch.isfinite(grad).all()


def _bf16_close(got: torch.Tensor, ref: np.ndarray):
    """>= 99 % bit-equal; every other element within 1 bf16 ulp, or within
    1e-5 of max|ref| where the output nearly cancels (two f32 summation
    orders differ by that much, which can be several ulps of a tiny sum)."""
    ref = torch.from_numpy(np.asarray(ref, np.float32)).to(BF16)
    assert got.dtype == BF16 and got.shape == ref.shape
    assert (got.view(torch.int16) == ref.view(torch.int16)).float().mean() >= 0.99
    a, b = got.float(), ref.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    d = (a - b).abs()
    assert ((d <= torch.exp2(torch.floor(torch.log2(mag)) - 7))
            | (d <= 1e-5 * b.abs().max())).all()


def _nchw(a):
    return torch.from_numpy(np.asarray(np.moveaxis(np.asarray(a, np.float32), -1, 1))).to(BF16)


@pytest.mark.parametrize('T,F,kt,kf,stride,dilation,padding', [
    (23, 67, 3, 9, (1, 2), (2, 1), (2, 4)),
    (23, 65, 3, 3, (1, 1), (1, 1), (1, 1)),
])
def test_k4_bf16_plain_versions_match_the_tpu_kernel(T, F, kt, kf, stride, dilation, padding):
    """K4's bf16 forward and dx plain versions against ``conv2d_v2`` and
    ``conv2d_v2_dx`` in interpret mode, bf16 in and out. One batch row: each
    interpret-mode grid step (a batch row's 8-row tile) costs ~0.5 s here,
    and T 23 already takes three tiles, the last ragged."""
    rng = np.random.default_rng(T + kf)
    x = jnp.asarray(rng.standard_normal((1, T, F, 32)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((kt, kf, 32, 32)) * 0.1, jnp.bfloat16)
    y = conv2d_v2(x, w, stride, dilation, padding, interpret=True)
    assert y.dtype == jnp.bfloat16
    wt = torch.from_numpy(np.asarray(jnp.transpose(w, (3, 2, 0, 1)), np.float32)).to(BF16)
    _bf16_close(dck.disc_conv_forward_reference(_nchw(x), wt, None, stride, dilation, padding),
                np.moveaxis(np.asarray(y, np.float32), -1, 1))
    g = jnp.asarray(rng.standard_normal(y.shape), jnp.bfloat16)
    dx = conv2d_v2_dx(g, w, stride, dilation, padding, x.shape, interpret=True)
    _bf16_close(dck.disc_conv_input_grad_reference(_nchw(g), wt, (1, 32, T, F), stride, dilation,
                                                   padding),
                np.moveaxis(np.asarray(dx, np.float32), -1, 1))


@pytest.mark.parametrize('dt', [1, 4])
def test_k5_bf16_plain_version_matches_the_tpu_kernel(dt):
    """K5's bf16 plain version (the im2col GEMM in f32 on bf16 operands,
    rounded to bf16) against ``conv2d_im2col`` in interpret mode."""
    rng = np.random.default_rng(dt)
    x = jnp.asarray(rng.standard_normal((1, 14, 33, 32)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((3, 9, 32, 32)) * 0.1, jnp.bfloat16)
    pt, pf = dt, 4
    y = conv2d_im2col(x, w, (pt, pf), (dt, 1), interpret=True)
    assert y.dtype == jnp.bfloat16
    wt = torch.from_numpy(np.asarray(jnp.transpose(w, (3, 2, 0, 1)), np.float32)).to(BF16)
    _bf16_close(k5.disc_im2col_forward_plain(_nchw(x), wt, None, (dt, 1), (pt, pf)),
                np.moveaxis(np.asarray(y, np.float32), -1, 1))


def test_bf16_plain_versions_add_the_bias_after_rounding():
    """The bias of a bf16 conv is added to the bf16-rounded sum, in bf16
    (``encodec_pytorch_tpu/ops/conv.py:263``), by every route of the port."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 32, 9, 41)).astype(np.float32)).to(BF16)
    w = torch.from_numpy(rng.standard_normal((32, 32, 3, 9)).astype(np.float32) * 0.1).to(BF16)
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32)).to(BF16)
    geo = ((1, 2), (1, 1), (1, 4))
    conv = dck.disc_conv_forward_reference(x, w, None, *geo)
    want = conv + b.reshape(1, -1, 1, 1)
    assert torch.equal(dck.disc_conv_forward_reference(x, w, b, *geo), want)
    assert torch.equal(dck.disc_conv_forward_bf16(x, w, b, *geo), want)
    assert torch.equal(k5.disc_im2col_forward_bf16(x, w, b, geo[1], geo[2]),
                       k5.disc_im2col_forward_plain(x, w, None, geo[1], geo[2])
                       + b.reshape(1, -1, 1, 1))


def test_bf16_weight_packing_moves_the_values():
    """The bf16 packings are permutations (plus zero padding) of the weights:
    every weight appears once, unrounded; K4's input-gradient packing holds
    every weight of both phases once, and none of phase 1's zero taps."""
    w = torch.randn(32, 32, 3, 9, generator=torch.Generator().manual_seed(0)).to(BF16)
    for packed in (dck.pack_weight_bf16(w.permute(1, 2, 3, 0)[None], 2),
                   dck.pack_weight_bf16(dck.pack_dx_weight(w, 2), 1), k5.pack_weight_bf16(w)):
        vals = packed.float().reshape(-1)
        assert packed.dtype == BF16
        assert torch.equal(vals[vals != 0].sort().values, w.float().reshape(-1).sort().values)
    # 27 taps: 14 k-steps; dx at sf 2: 15 taps of phase 0 in 8, 12 of phase 1 in 6
    assert dck.pack_weight_bf16(dck.pack_dx_weight(w, 2), 1).shape == (1, 4, 14, 512)


# K4's bf16 kernel (csrc/disc_conv_bf16.cu), emulated by its index maps: the
# tile grid, the 16-byte-aligned raw pieces, the channels-last layout, the
# wgmma descriptors and the B images
ROWS, COLS, CC = 32, 8, 8


def _k4_bf16_geometry(x_shape, w_shape, stride, dilation, padding, dx):
    """The correlation the kernel runs (csrc/disc_conv_bf16.cu ``geometry``)."""
    (B, Cin, T, F), (Cout, _, KT, KF) = x_shape, w_shape
    sf, dt, (pt, pf) = stride[1], dilation[0], padding
    To, Fo = dck.out_size(T, F, KT, KF, sf, dt, pt, pf)
    if not dx:
        g = dict(S=sf, NJ=KF, P=1, C=Cin, O=Cout, Tin=T, Fin=F, Tout=To, Fout=Fo, t_off=-pt,
                 col_off=-pf, OS=1, q=[(0, Fo, 0)])
    else:
        NJ = -(-KF // sf)
        g = dict(S=1, NJ=NJ, P=sf, C=Cout, O=Cin, Tin=To, Fin=Fo, Tout=T, Fout=F,
                 t_off=pt - (KT - 1) * dt, col_off=-(NJ - 1), OS=sf,
                 q=[(-((r - pf) // sf), (F - 1 + pf - r) // sf + 1, r - pf) for r in range(sf)])
    g.update(B=B, KT=KT, dt=dt, R=ROWS + (KT - 1) * dt)
    return g


def _emulate_k4_bf16(inp: torch.Tensor, image: torch.Tensor, g: dict, base_e: int):
    """The kernel's f32 sums (before any rounding) from ``inp`` (the
    correlation's input, bf16) and its B images, with ``inp`` placed at an
    address of ``base_e`` mod 8 elements: every raw piece the kernel does not
    copy holds NaN, as does memory around ``inp``, so a value the layout
    should have masked shows. A tile is ROWS rows of one image and 16 / P
    correlation columns; its m64 tiles are 8 rows x 8 columns, at P 1 two
    column blocks, at P 2 the two phases of the same columns."""
    S, NJ, P, KT, dt, R = g['S'], g['NJ'], g['P'], g['KT'], g['dt'], g['R']
    B, C, Tin, Fin = inp.shape
    QC = 16 // P
    W = (QC - 1) * S + NJ
    half = (W + 1) // 2 if S == 2 else W
    npiece = (W + 14) // 8
    flat = torch.cat([torch.full((16,), float('nan')), inp.float().reshape(-1),
                      torch.full((16,), float('nan'))])
    steps = [dck.bf16_steps(S, KT, NJ, P, r) for r in range(P)]
    scol = lambda j: dck.bf16_staged_col(S, NJ, j)
    col_rel = torch.tensor([2 * sc if sc < half else 2 * (sc - half) + 1 for sc in range(W)]
                           if S == 2 else list(range(W)))
    q_start = min(lo for lo, _, _ in g['q'])
    n_qb = -(-(max(hi for _, hi, _ in g['q']) - q_start) // QC)
    n_chunks, o_tiles = -(-C // CC), image.shape[0]
    out = torch.zeros(B, g['O'], g['Tout'], g['Fout'])
    for b in range(B):
        for tb in range(-(-g['Tout'] // ROWS)):
            for qb in range(n_qb):
                t0, q0 = tb * ROWS, q_start + qb * QC
                wbase, rbase = q0 * S + g['col_off'], t0 + g['t_off']
                acc = torch.zeros(o_tiles, ROWS // 8, 2, 64, 32)
                for chunk in range(n_chunks):
                    raw = torch.full((CC, R, 8 * npiece), float('nan'))
                    pairs = torch.zeros(R, W, CC)
                    for c in range(CC):
                        ch = chunk * CC + c
                        for r in range(R):
                            row = rbase + r
                            if ch >= C or not 0 <= row < Tin:
                                continue
                            idx = ((b * C + ch) * Tin + row) * Fin + wbase
                            shift = (base_e + idx) % 8
                            for pc in range(npiece):
                                col0 = wbase - shift + 8 * pc
                                if col0 < Fin and col0 + 8 > 0:
                                    at = idx - shift + 8 * pc + 16
                                    raw[c, r, 8 * pc:8 * pc + 8] = flat[at:at + 8]
                            cols = wbase + col_rel
                            ok = (cols >= 0) & (cols < Fin)
                            pairs[r, ok, c] = raw[c, r, shift + col_rel[ok]]
                    pairs = pairs.reshape(-1, CC)
                    for ot in range(o_tiles):
                        for rg in range(ROWS // 8):              # 8-row groups
                            for v in range(2):                   # column block or phase
                                r_ph = v if P == 2 else 0
                                base = len(steps[0]) if P == 2 and v == 1 else 0
                                start = 8 * rg * W + (0 if P == 2 else 8 * v)
                                for s, (t0_, t1_) in enumerate(steps[r_ph]):
                                    off = t0_[0] * dt * W + scol(t0_[1])
                                    lbo = 0 if t1_ is None else (t1_[0] * dt * W + scol(t1_[1])
                                                                 - off)
                                    assert lbo >= 0       # a descriptor offset is unsigned
                                    m = torch.arange(64)
                                    rows_a = start + off + (m // 8) * W + m % 8
                                    A = torch.cat([pairs[rows_a], pairs[rows_a + lbo]], 1)
                                    e = image[ot, chunk, base + s].float()
                                    n, k = torch.arange(32)[None, :], torch.arange(16)[:, None]
                                    Bm = e[(n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8]
                                    acc[ot, rg, v] += A @ Bm
                for ot in range(o_tiles):
                    o = ot * 32 + torch.arange(32)
                    ok = o < g['O']
                    for rg in range(ROWS // 8):
                        for v in range(2):
                            r_ph = v if P == 2 else 0
                            lo, hi, ooff = g['q'][r_ph]
                            for m in range(64):
                                t = t0 + 8 * rg + m // 8
                                q = q0 + m % 8 + (0 if P == 2 else 8 * v)
                                if t < g['Tout'] and lo <= q < hi:
                                    out[b, o[ok], t, q * g['OS'] + ooff] = acc[ot, rg, v, m][ok]
    return out


@pytest.mark.parametrize('B,Cin,Cout,T,F,k,stride,dilation,padding,base_e', [
    (3, 12, 40, 13, 33, (3, 9), (1, 2), (1, 1), (1, 4), 3),      # odd B, ragged C and O
    (1, 16, 32, 40, 65, (3, 9), (1, 2), (2, 1), (2, 4), 0),      # two row tiles
    (1, 8, 32, 19, 17, (3, 9), (1, 2), (4, 1), (4, 4), 5),
    (2, 8, 32, 18, 33, (3, 3), (1, 1), (1, 1), (1, 1), 1),
])
def test_k4_bf16_kernel_index_maps_hold_the_plain_versions(B, Cin, Cout, T, F, k, stride,
                                                           dilation, padding, base_e):
    """The bf16 kernel's data movement, emulated on the CPU from its index
    maps (16-byte pieces of rows of any alignment, the channels-last layout
    with even columns first at F-stride 2, the wgmma descriptors of each
    k-step, the B images of ``pack_weight_bf16``), summed in f32: forward
    and input gradient (both phases at sf 2) within 1e-5 of max of the f32
    plain versions, at 2^k + 1 columns, T dilations 1, 2 and 4 and rows that
    start at odd addresses."""
    gen = torch.Generator().manual_seed(T * F + Cin)
    x = torch.randn(B, Cin, T, F, generator=gen).to(BF16)
    w = (torch.randn(Cout, Cin, *k, generator=gen) / 10).to(BF16)
    geo = (stride, dilation, padding)
    y = dck.disc_conv_forward_reference(x.float(), w.float(), None, *geo)
    gy = torch.randn(y.shape, generator=gen).to(BF16)
    fwd = _k4_bf16_geometry(x.shape, w.shape, *geo, dx=False)
    got = _emulate_k4_bf16(x, dck.pack_weight_bf16(w.permute(1, 2, 3, 0)[None], stride[1]),
                           fwd, base_e)
    assert (got - y).abs().max() <= 1e-5 * y.abs().max()
    dxg = _k4_bf16_geometry(x.shape, w.shape, *geo, dx=True)
    got = _emulate_k4_bf16(gy, dck.pack_weight_bf16(dck.pack_dx_weight(w, stride[1]), 1), dxg,
                           base_e)
    ref = dck.disc_conv_input_grad_reference(gy.float(), w.float(), x.shape, *geo)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


# K5's bf16 kernel (csrc/disc_im2col_bf16.cu), emulated by its index maps: the
# tile grid, the units of 8 input columns loaded as 16-byte-aligned pieces
# and shifted by the row's alignment, the transposed stmatrix stores into the
# channels-last window (even input columns first, odd from slot K5_OB), the
# wgmma descriptors of each k-step and the B images. The constants mirror the
# kernel's.
K5_ROWS, K5_FT, K5_G, K5_OB, K5_RS = 32, 16, 5, 21, 41


def _emulate_k5_bf16(x: torch.Tensor, image: torch.Tensor, dt: int, pt: int, pf: int,
                     base_e: int) -> torch.Tensor:
    """The kernel's f32 sums (before any rounding) from ``x`` (bf16 [B, 32,
    T, F]) placed at an address of ``base_e`` mod 8 elements, and its B
    images: memory around ``x`` and every slot of a stage that no store
    writes hold NaN, so a value the kernel should have masked, or a slot it
    reads and never writes, shows."""
    B, C, T, F = x.shape
    To, Fo = dck.out_size(T, F, 3, 9, 2, dt, pt, pf)
    R = K5_ROWS + 2 * dt
    NU = R * K5_G
    NIT = -(-NU // 4)
    RA = -(-4 * NIT // K5_G)
    pad = 16
    mem = torch.full((pad + base_e + x.numel() + 2 * pad,), float('nan'))
    mem[pad + base_e:pad + base_e + x.numel()] = x.float().reshape(-1)
    # the producer's units: u = 4 * iteration + q, lane 4c + q holds channel c
    u = torch.arange(4 * NIT)
    ur, ug = u // K5_G, u % K5_G
    j8 = torch.arange(8)
    # the consumers' taps in address order, as offsets in a stage (slots)
    order = list(k5.TAP_ORDER_BF16) + [None]
    slot = lambda col: K5_OB + col // 2 if col % 2 else col // 2
    off = [None if t is None else (t // 9) * dt * K5_RS + slot(t % 9) for t in order]
    n, k = torch.arange(32)[None, :], torch.arange(16)[:, None]
    b_index = (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8
    m = torch.arange(64)
    # stmatrix .x4 .trans: the row rr of matrix mm (an address from lane 8 mm +
    # rr) gets channel C's element 2 mm + rr % 2 of unit q = rr // 2, from
    # lane 4C + q
    it = torch.arange(NIT)[:, None, None]
    mm = torch.arange(4)[None, :, None]
    rr = torch.arange(8)[None, None, :]
    uu = (4 * it + rr // 2).expand(NIT, 4, 8)
    el = (2 * mm + rr % 2).expand(NIT, 4, 8)
    cc = 8 * (uu % K5_G) + el
    flat = ((uu // K5_G) * K5_RS + torch.where(cc % 2 == 1, K5_OB + cc // 2, cc // 2)).reshape(-1)
    at = lambda a: mem[a.clamp(0, mem.numel() - 1)]
    out = torch.zeros(B, 32, To, Fo)
    for b in range(B):
        for tb in range(-(-To // K5_ROWS)):
            for cb in range(-(-Fo // K5_FT)):
                t0, f0 = tb * K5_ROWS, cb * K5_FT
                row, col = t0 - pt + ur, 2 * f0 - pf + 8 * ug           # [U]
                ok = (u < NU) & (row >= 0) & (row < T)
                acc = torch.zeros(8, 64, 32)
                for chunk in range(4):
                    ch = chunk * 8 + torch.arange(8)[:, None]           # [8, 1]
                    a = pad + base_e + ((b * C + ch) * T + row) * F + col  # [8, U]
                    s = a % 8
                    a16 = a - s
                    # a piece is read only if it holds an element of the unit in x
                    ld0 = ok & (col < F) & (col + 7 - s >= 0)
                    ld1 = ok & (s > 0) & (col + 8 - s < F) & (col + 7 >= 0)
                    pieces = torch.cat([
                        torch.where(ld0[..., None], at(a16[..., None] + j8), 0.),
                        torch.where(ld1[..., None], at(a16[..., None] + 8 + j8), 0.)], -1)
                    v = pieces.gather(-1, s[..., None] + j8)             # [8, U, 8]
                    valid = ok[:, None] & (col[:, None] + j8 >= 0) & (col[:, None] + j8 < F)
                    v = torch.where(valid, v, 0.)
                    stage = torch.full((RA * K5_RS, 8), float('nan'))
                    stage[flat] = v[:, uu.reshape(-1), el.reshape(-1)].t()
                    for v_ in range(8):                                 # the 8 m64 tiles
                        base = 8 * (v_ // 2) * K5_RS + 8 * (v_ % 2)
                        for st in range(14):
                            o0, o1 = off[2 * st], off[2 * st + 1]
                            lbo = 0 if o1 is None else o1 - o0
                            assert lbo >= 0                # a descriptor offset is unsigned
                            rows_a = base + o0 + (m // 8) * K5_RS + m % 8
                            A = torch.cat([stage[rows_a], stage[rows_a + lbo]], 1)
                            e = image[chunk, st].float()
                            acc[v_] += A @ e[b_index]
                for v_ in range(8):
                    t = t0 + 8 * (v_ // 2) + m // 8
                    f = f0 + 8 * (v_ % 2) + m % 8
                    keep = (t < To) & (f < Fo)
                    out[b, :, t[keep], f[keep]] = acc[v_][keep].t()
    return out


@pytest.mark.parametrize('B,T,Fo,dt,base_e', [
    (1, 21, 33, 1, 0),
    (1, 40, 33, 2, 3),       # two row tiles
    (1, 19, 33, 4, 5),
    (2, 9, 65, 1, 7),
    (1, 13, 65, 2, 1),
    (1, 33, 65, 4, 6),
])
def test_k5_bf16_kernel_index_maps_hold_the_plain_version(B, T, Fo, dt, base_e):
    """K5's bf16 kernel's data movement, emulated on the CPU from its index
    maps (16-byte pieces of rows of any alignment, shifted into 8-column
    units, stored transposed by stmatrix into the channels-last window with
    even columns first, the wgmma descriptors of each k-step with taps in
    address order, the B images of ``pack_weight_bf16``), summed in f32:
    within 1e-5 of max of the f32 plain version, at Fo = 2^k + 1, T
    dilations 1, 2 and 4, ragged row tiles and rows that start at any
    address mod 16 bytes."""
    gen = torch.Generator().manual_seed(T * Fo + dt)
    x = torch.randn(B, 32, T, 2 * Fo - 1, generator=gen).to(BF16)
    w = (torch.randn(32, 32, 3, 9, generator=gen) / 10).to(BF16)
    geo = ((dt, 1), (dt, 4))
    y = k5.disc_im2col_forward_plain(x.float(), w.float(), None, *geo)
    got = _emulate_k5_bf16(x, k5.pack_weight_bf16(w), dt, dt, 4, base_e)
    assert got.shape == y.shape
    assert (got - y).abs().max() <= 1e-5 * y.abs().max()
