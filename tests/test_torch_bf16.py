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
    ``conv2d_v2_dx`` in interpret mode, bf16 in and out."""
    rng = np.random.default_rng(T + kf)
    x = jnp.asarray(rng.standard_normal((2, T, F, 32)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((kt, kf, 32, 32)) * 0.1, jnp.bfloat16)
    y = conv2d_v2(x, w, stride, dilation, padding, interpret=True)
    assert y.dtype == jnp.bfloat16
    wt = torch.from_numpy(np.asarray(jnp.transpose(w, (3, 2, 0, 1)), np.float32)).to(BF16)
    _bf16_close(dck.disc_conv_forward_reference(_nchw(x), wt, None, stride, dilation, padding),
                np.moveaxis(np.asarray(y, np.float32), -1, 1))
    g = jnp.asarray(rng.standard_normal(y.shape), jnp.bfloat16)
    dx = conv2d_v2_dx(g, w, stride, dilation, padding, x.shape, interpret=True)
    _bf16_close(dck.disc_conv_input_grad_reference(_nchw(g), wt, (2, 32, T, F), stride, dilation,
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
    every weight appears once, unrounded."""
    w = torch.randn(32, 32, 3, 9, generator=torch.Generator().manual_seed(0)).to(BF16)
    for packed in (dck.pack_weight_bf16(w.permute(1, 2, 3, 0)[None]), k5.pack_weight_bf16(w)):
        vals = packed.float().reshape(-1)
        assert packed.dtype == BF16
        assert torch.equal(vals[vals != 0].sort().values, w.float().reshape(-1).sort().values)
