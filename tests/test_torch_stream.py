"""The port's streaming codec vs the JAX package's on the CPU.

A tiny causal model (``n_filters=4``, ``n_q=4``, random-normal codebooks,
numpy-seeded weights) is built on the JAX side and carried into the port with
``convert.state_dict_from_jax``. The same chunks go through
``encodec_pytorch_tpu.streaming`` (jitted) and ``encodec_pytorch_tpu_torch.
streaming`` (kernels K3, K2 and K1 run as their plain versions on the CPU).
Bars, those of tests/test_streaming.py: codes exactly equal, floats to atol
2e-5, rtol 1e-5. Also: streamed against the port's own offline model over an
uneven chunk pattern, a stream started in JAX and continued in the port
(``convert.streaming_state_from_jax``), the stateful LSTM against
``streaming._stream_lstm`` (atol 1e-5), and the constraint errors.

bf16 (the mirror of tests/test_streaming.py's
``test_streaming_codec_bf16_matches_offline``: n_filters 8, n_q 4, 3 kbps,
48 hops of a 313 Hz sine, the JAX package's uneven chunks): the port's
streamed codes equal its offline bf16 codes and the JAX bf16 stream's, the
wav is within 2e-2 of offline; a one-chunk stream's latent is the offline
latent bit for bit, and the chunked stream's wav is within 1e-3 of offline
by relative norm while the same weights streamed in f32 are over 1e-3 away
(measured: 7.2e-5 and 5.9e-3), so the stream does run in bf16.

int8 (the mirror of tests/test_prepare.py's int8 streaming case): the int8
twin of the tiny model (``prepare.quantize_weights``) streamed with
``roundtrip_chunk`` over uneven chunks equals its offline ``quantized_call``
to atol 2e-5, its codes exactly, with its blocks through K3's int8 entry
(its plain version here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu import streaming as jstreaming
from encodec_pytorch_tpu.models.model import EncodecModel as JaxModel
from encodec_pytorch_tpu_torch import convert, prepare
from encodec_pytorch_tpu_torch import streaming as tstreaming
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.ops.lstm import SLSTM
from test_streaming import _chunks
from test_torch_ops import numpy_params

torch.set_num_threads(1)

TINY = dict(target_bandwidths=[1.5, 3., 6.], sample_rate=24000, channels=1, causal=True,
            model_norm='weight_norm', name='encodec_24khz', n_q=4, n_filters=4)
HOP = 320
STEADY = 2 * HOP      # every chunk after the first: one JAX program
N_STEADY = 4
ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture(scope='module')
def models():
    jm = JaxModel._get_model(audio_normalize=False, segment=None, **TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), example_length=2400))
    rng = np.random.default_rng(0)
    n_q, bins, dim = shapes['quantizer'].embed.shape
    embed = rng.standard_normal((n_q, bins, dim)).astype(np.float32)
    variables = {
        'params': numpy_params(shapes['params'], rng),
        'quantizer': shapes['quantizer']._replace(
            inited=np.ones(n_q, np.float32), cluster_size=np.ones((n_q, bins), np.float32),
            embed=embed, embed_avg=embed),
    }
    jm.set_target_bandwidth(3.)
    tm = EncodecModel._get_model(**TINY)
    tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    tm.eval().set_target_bandwidth(3.)
    return jm, variables, tm


def _wav(length, seed):
    t = np.arange(length) / 24000
    rng = np.random.default_rng(seed)
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(length)
    return x.astype(np.float32).reshape(1, 1, length)


def _sizes(first, total, pattern):
    sizes, i = [first], 0
    while sum(sizes) < total:
        sizes.append(min(pattern[i % len(pattern)], total - sum(sizes)))
        i += 1
    return sizes


def _np_state(state):
    return jax.tree.map(np.asarray, jax.device_get(state))


def _assert_states_close(port, ref):
    flat_p, _ = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), port))
    flat_r, _ = jax.tree.flatten(ref)
    assert len(flat_p) == len(flat_r)
    for a, b in zip(flat_p, flat_r):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope='module')
def jax_run(models):
    """The JAX StreamingCodec over a first chunk and N_STEADY steady chunks:
    per chunk (wav, codes, state after it), numpy."""
    jm, variables, _ = models
    codec = jstreaming.StreamingCodec(jm)
    first = codec.min_first_chunk_samples
    wav = _wav(first + N_STEADY * STEADY, 1)
    enc, dec = codec.init_state(1)
    chunks, pos = [], 0
    for i, n in enumerate([first] + [STEADY] * N_STEADY):
        out, codes, enc, dec = codec.roundtrip_chunk(variables, enc, dec,
                                                     jnp.asarray(wav[..., pos:pos + n]),
                                                     first=(i == 0))
        chunks.append((np.asarray(out), np.asarray(codes), _np_state((enc, dec))))
        pos += n
    return wav, first, chunks


@pytest.mark.parametrize('part', ['encoder', 'decoder'])
def test_seanet_streams_match_jax(models, part):
    jm, variables, tm = models
    jnet = jstreaming.StreamingSEANet(getattr(jm, part))
    tnet = tstreaming.StreamingSEANet(getattr(tm, part))
    apply = jax.jit(jnet.apply, static_argnames='first')
    params = variables['params'][part]
    if part == 'encoder':
        first = -(-jnet.min_first_chunk // HOP) * HOP
        x = _wav(first + 3 * STEADY, 2)[:, 0][..., None]                  # [B, T, 1]
        sizes = [first] + [STEADY] * 3
    else:
        first = jnet.min_first_chunk
        x = np.random.default_rng(3).standard_normal((2, first + 6, 128)).astype(np.float32)
        sizes = [first, 2, 2, 2]
    jstate, tstate, pos = jnet.init_state(x.shape[0]), tnet.init_state(x.shape[0]), 0
    for i, n in enumerate(sizes):
        chunk = x[:, pos:pos + n]
        ref, jstate = apply(params, jstate, jnp.asarray(chunk), first=(i == 0))
        got, tstate = tnet.apply(tstate, torch.from_numpy(np.ascontiguousarray(
            np.transpose(chunk, (0, 2, 1)))), first=(i == 0))
        np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 1)), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL)
        pos += n
    _assert_states_close(tstate, jax.tree.map(
        lambda t: t.numpy(), convert.streaming_state_from_jax(_np_state(jstate))))


def test_codec_roundtrip_matches_jax(models, jax_run):
    _, _, tm = models
    wav, first, chunks = jax_run
    codec = tstreaming.StreamingCodec(tm)
    assert codec.min_first_chunk_samples == first == 2240
    enc, dec = codec.init_state(1)
    enc2, dec2 = codec.init_state(1)
    pos = 0
    for i, (ref_wav, ref_codes, _) in enumerate(chunks):
        n = first if i == 0 else STEADY
        x = torch.from_numpy(wav[..., pos:pos + n])
        out, codes, enc, dec = codec.roundtrip_chunk(enc, dec, x, first=(i == 0))
        np.testing.assert_array_equal(codes.numpy(), ref_codes)
        np.testing.assert_allclose(out.numpy(), ref_wav, atol=ATOL, rtol=RTOL)
        # encode_chunk -> decode_chunk is the same math
        codes2, enc2 = codec.encode_chunk(enc2, x, first=(i == 0))
        out2, dec2 = codec.decode_chunk(dec2, codes2, first=(i == 0))
        np.testing.assert_array_equal(codes2.numpy(), codes.numpy())
        np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=1e-6, rtol=0)
        pos += n
    _assert_states_close((enc, dec), jax.tree.map(
        lambda t: t.numpy(), convert.streaming_state_from_jax(chunks[-1][2])))


def test_handover_from_jax(models, jax_run):
    """The first two chunks in JAX; the rest in the port from the converted
    state: equal to JAX continuing."""
    _, _, tm = models
    wav, first, chunks = jax_run
    codec = tstreaming.StreamingCodec(tm)
    enc, dec = convert.streaming_state_from_jax(chunks[1][2])
    pos = first + STEADY
    for ref_wav, ref_codes, _ in chunks[2:]:
        out, codes, enc, dec = codec.roundtrip_chunk(
            enc, dec, torch.from_numpy(wav[..., pos:pos + STEADY]))
        np.testing.assert_array_equal(codes.numpy(), ref_codes)
        np.testing.assert_allclose(out.numpy(), ref_wav, atol=ATOL, rtol=RTOL)
        pos += STEADY


def test_streamed_matches_port_offline(models):
    """Uneven chunks (1, 3, 2, 1, 4 hops after the first) against the port's
    offline encode and decode of the whole clip."""
    _, _, tm = models
    codec = tstreaming.StreamingCodec(tm)
    T = HOP * 30
    wav = torch.from_numpy(_wav(T, 4))
    offline_codes = tm.encode(wav)[0][0]
    offline = tm(wav)
    enc, dec = codec.init_state(1)
    outs, codes, pos = [], [], 0
    for i, n in enumerate(_sizes(codec.min_first_chunk_samples, T,
                                 [HOP, 3 * HOP, 2 * HOP, HOP, 4 * HOP])):
        out, c, enc, dec = codec.roundtrip_chunk(enc, dec, wav[..., pos:pos + n], first=(i == 0))
        outs.append(out)
        codes.append(c)
        pos += n
    np.testing.assert_array_equal(torch.cat(codes, -1).numpy(), offline_codes.numpy())
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), offline.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_int8_stream_matches_offline_int8(models, monkeypatch):
    _, _, tm = models
    qm = prepare.quantize_weights(prepare.fold_weight_norm(tm))
    codec = tstreaming.StreamingCodec(qm)
    T = HOP * 16
    wav = torch.from_numpy(_wav(T, 6))
    offline_codes = qm.encode(wav)[0][0]
    offline = prepare.quantized_call(qm, wav)
    calls = []
    real = tstreaming.SEANetResnetBlock.fused_call
    monkeypatch.setattr(tstreaming.SEANetResnetBlock, 'fused_call',
                        lambda self, *a, **kw: calls.append(self.int8) or real(self, *a, **kw))
    enc, dec = codec.init_state(1)
    outs, codes, pos = [], [], 0
    for i, n in enumerate(_sizes(codec.min_first_chunk_samples, T, [HOP, 2 * HOP, 3 * HOP])):
        out, c, enc, dec = codec.roundtrip_chunk(enc, dec, wav[..., pos:pos + n], first=(i == 0))
        outs.append(out)
        codes.append(c)
        pos += n
    assert calls and all(calls)
    np.testing.assert_array_equal(torch.cat(codes, -1).numpy(), offline_codes.numpy())
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), offline.numpy(), atol=ATOL)


def test_stateful_lstm_matches_jax():
    """Two layers from a random carried (h, c): K2's plain version against the
    JAX ``_stream_lstm`` scan, output and new carry."""
    H, B, T, L = 16, 3, 7, 2
    rng = np.random.default_rng(5)
    bound = 1 / np.sqrt(H)
    p = {}
    for k in range(L):
        p[f'w_ih_l{k}'] = rng.uniform(-bound, bound, (H, 4 * H)).astype(np.float32)
        p[f'w_hh_l{k}'] = rng.uniform(-bound, bound, (H, 4 * H)).astype(np.float32)
        p[f'b_l{k}'] = rng.uniform(-bound, bound, (4 * H,)).astype(np.float32)
    h0 = rng.standard_normal((L, B, H)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((L, B, H)).astype(np.float32)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    spec = jstreaming.LstmSpec('lstm', H, L)
    ref, (rh, rc) = jstreaming._stream_lstm(p, spec, (jnp.asarray(h0), jnp.asarray(c0)),
                                            jnp.asarray(x), jnp.float32)

    slstm = SLSTM(H, L)
    sd = convert.seanet_state_dict({'layer_0': p})
    slstm.load_state_dict({k.split('.', 2)[2]: torch.from_numpy(v) for k, v in sd.items()})
    carry = (torch.from_numpy(h0).transpose(0, 1), torch.from_numpy(c0).transpose(0, 1))
    with torch.no_grad():
        got, (gh, gc) = tstreaming._stream_lstm(slstm, tstreaming.LstmSpec('lstm', H, L),
                                                carry, torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gh.transpose(0, 1).numpy(), np.asarray(rh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gc.transpose(0, 1).numpy(), np.asarray(rc), atol=1e-5, rtol=0)


def test_constraint_errors(models):
    _, _, tm = models
    codec = tstreaming.StreamingCodec(tm)
    enc, _ = codec.init_state(1)
    with pytest.raises(ValueError, match='multiple'):
        codec.encode_chunk(enc, torch.zeros(1, 1, 321), first=True)
    with pytest.raises(ValueError, match='first chunk too short'):
        codec.encode_chunk(enc, torch.zeros(1, 1, 2 * HOP), first=True)
    normalized = EncodecModel._get_model([3.], 24000, 1, causal=True, audio_normalize=True,
                                         n_q=2, n_filters=4)
    with pytest.raises(ValueError, match='normalize'):
        tstreaming.StreamingCodec(normalized)
    non_causal = EncodecModel._get_model([3.], 24000, 1, causal=False, n_q=2, n_filters=4)
    with pytest.raises(ValueError, match='causal'):
        tstreaming.StreamingCodec(non_causal)
    convtr = tm.decoder.model[3]
    convtr.trim_right_ratio = 0.5
    try:
        with pytest.raises(ValueError, match='trim_right_ratio'):
            tstreaming.StreamingSEANet(tm.decoder)
    finally:
        convtr.trim_right_ratio = 1.


BF16 = dict(target_bandwidths=[1.5, 3., 6.], sample_rate=24000, channels=1, causal=True,
            model_norm='weight_norm', n_q=4, n_filters=8)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def test_bf16_stream_matches_offline_and_jax():
    jm = JaxModel._get_model(audio_normalize=False, segment=None, dtype=jnp.bfloat16, **BF16)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), example_length=2400))
    rng = np.random.default_rng(6)
    n_q, bins, dim = shapes['quantizer'].embed.shape
    embed = rng.standard_normal((n_q, bins, dim)).astype(np.float32)
    variables = {
        'params': numpy_params(shapes['params'], rng),
        'quantizer': shapes['quantizer']._replace(
            inited=np.ones(n_q, np.float32), cluster_size=np.ones((n_q, bins), np.float32),
            embed=embed, embed_avg=embed),
    }
    jm.set_target_bandwidth(3.)
    ports = {}
    for dtype in (torch.bfloat16, torch.float32):
        ports[dtype] = EncodecModel._get_model(dtype=dtype, **BF16)
        ports[dtype].load_state_dict(convert.state_dict_from_jax(variables), strict=True)
        ports[dtype].eval().set_target_bandwidth(3.)
    tm = ports[torch.bfloat16]

    T = HOP * 48
    wav = (0.5 * np.sin(np.arange(T) / 24000.0 * 2 * np.pi * 313)).reshape(1, 1, T).astype(
        np.float32)
    jcodec = jstreaming.StreamingCodec(jm)
    sizes = _chunks(T, jcodec.min_first_chunk_samples, HOP)
    enc, dec = jcodec.init_state(1)
    jax_codes, pos = [], 0
    for i, n in enumerate(sizes):
        _, codes, enc, dec = jcodec.roundtrip_chunk(variables, enc, dec,
                                                    jnp.asarray(wav[..., pos:pos + n]),
                                                    first=(i == 0))
        jax_codes.append(np.asarray(codes))
        pos += n

    def stream(model):
        codec = tstreaming.StreamingCodec(model)
        enc, dec = codec.init_state(1)
        outs, codes, pos = [], [], 0
        for i, n in enumerate(sizes):
            out, c, enc, dec = codec.roundtrip_chunk(enc, dec, x[..., pos:pos + n],
                                                     first=(i == 0))
            outs.append(out)
            codes.append(c)
            pos += n
        assert all(t.dtype == torch.float32 for t in jax.tree.leaves((enc, dec)))
        return torch.cat(codes, -1), torch.cat(outs, -1)

    x = torch.from_numpy(wav)
    codes, out = stream(tm)
    with torch.no_grad():
        offline_codes = tm.encode(x)[0][0]
        offline = tm(x)
        latent = tm.encoder(x)
    np.testing.assert_array_equal(codes.numpy(), offline_codes.numpy())
    np.testing.assert_array_equal(codes.numpy(), np.concatenate(jax_codes, -1))
    np.testing.assert_allclose(out.numpy(), offline.numpy(), atol=2e-2, rtol=2e-2)
    # one chunk: the offline arithmetic bit for bit; chunked, only the f32
    # summation order of CPU convs of other lengths differs
    net = tstreaming.StreamingSEANet(tm.encoder)
    one, _ = net.apply(net.init_state(1), x, first=True)
    assert torch.equal(one, latent)
    assert _rel(out, offline) < 1e-3
    assert _rel(stream(ports[torch.float32])[1], offline) > 1e-3
