"""The port's serving runtime (``encodec_pytorch_tpu_torch/serve.py``) on the CPU.

Modelled on tests/test_serve.py and tests/test_streaming_server.py, at a tiny
width (``n_filters=4``, ``n_q=4``) with ``device='cpu'``:

- ``CodecServer`` coalesces queued requests into one padded dispatch, keeps
  incompatible ones apart, and every result equals the direct ``LiveCodec``
  call (atol 1e-6: batch-size float noise only); length buckets are exact for
  the constant-pad model and tail-exact (all but the final frame and hop) for
  the reflect model; a normalizing model is refused; errors reach the caller's
  future and the server keeps serving.
- ``StreamingServer`` multiplexes streams (one joining late) and each equals
  ``StreamingCodec`` alone on its signal, codes exactly and audio to atol 2e-5;
  a reused slot starts fresh; a failed step closes the active streams and the
  server serves new ones.
- int8 weight-only serving: ``LiveCodec(weights='int8')`` builds and serves
  its model's int8 twin (``prepare.quantized_call`` of it, bit for bit), an
  unknown ``weights`` raises ``ValueError``; a 2-slot ``StreamingServer``
  over the twin equals its offline forward to atol 2e-5, rtol 1e-5 (the bar
  of ``tests/test_streaming_server.py``'s int8 test).

Every ``result`` and ``join`` has a timeout of its own, so a hang fails one
test. JAX is not needed: these are the port against itself.
"""

import threading

import numpy as np
import pytest
import torch

from encodec_pytorch_tpu_torch import prepare
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec, StreamingServer
from encodec_pytorch_tpu_torch.streaming import StreamingCodec

torch.set_num_threads(1)

TIMEOUT = 60


def _model(pad_mode='reflect', normalize=False):
    model = EncodecModel._get_model([1.5, 3.], 24000, 1, causal=True, audio_normalize=normalize,
                                    name='encodec_24khz', n_q=4, n_filters=4, pad_mode=pad_mode,
                                    generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    for layer in model.quantizer.vq.layers:
        layer._codebook.embed.normal_(generator=gen)
    model.set_target_bandwidth(3.)
    return model


@pytest.fixture(scope='module')
def live():
    return LiveCodec(_model(), device='cpu')


@pytest.fixture(scope='module')
def live_const():
    return LiveCodec(_model('constant'), device='cpu')


def _clips(n, t, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, t)) * 0.1).astype(np.float32) for _ in range(n)]


def _direct(codec, clip, bandwidth=None):
    return codec.roundtrip(clip[None], bandwidth=bandwidth)[0].numpy()


def _join_all(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), 'a caller thread hung'


def test_live_codec_and_refusals(live):
    x = _clips(1, 2400)[0][None]
    codes = live.encode(x, bandwidth=1.5)
    assert codes[0].shape == (1, 2, 8)                  # n_q 2 at 1.5 kbps
    dec = live.decode(codes, bandwidth=1.5, length=2000)
    model = live.model
    model.set_target_bandwidth(1.5)
    ref = model(torch.from_numpy(x))
    np.testing.assert_allclose(dec.numpy(), ref[..., :2000].numpy(), atol=1e-6)
    assert live.encode(x)[0].shape[1] == 4              # default: 3 kbps, n_q 4
    live8 = LiveCodec(model, weights='int8', device='cpu')
    assert live8.model is not model and prepare.param_bytes(live8.model) < \
        0.35 * prepare.param_bytes(model)
    out8 = live8.roundtrip(x)
    live8.model.set_target_bandwidth(live8.default_bandwidth)
    np.testing.assert_array_equal(out8.numpy(),
                                  prepare.quantized_call(live8.model, torch.from_numpy(x)).numpy())
    with pytest.raises(ValueError, match="'int8'"):
        LiveCodec(model, weights='int4', device='cpu')
    with pytest.raises(TypeError, match='DeployedCodec.load'):
        CodecServer('codec.ecdz')
    with pytest.raises(ValueError, match='move it'):
        LiveCodec(model, device='meta')


def test_server_coalesces_and_matches(live):
    clips = _clips(5, 2400, seed=1)
    direct = [_direct(live, c) for c in clips]
    server = CodecServer(live, max_batch=8, max_wait_ms=1.0)
    futures = [server.submit('roundtrip', c) for c in clips]   # before the worker starts
    server.start()
    try:
        outs = [f.result(timeout=TIMEOUT) for f in futures]
    finally:
        server.stop()
    for out, ref in zip(outs, direct):
        assert out.shape == ref.shape == (1, 2400)
        np.testing.assert_allclose(out, ref, atol=1e-6)
    s = server.stats()
    assert s['requests'] == 5 and s['batches'] == 1
    assert s['mean_batch'] == 5 and s['padded_items'] == 3     # bucket 8
    assert 'latency_p50_ms' in s


def test_server_separates_incompatible_and_threads(live):
    a, b = _clips(1, 2400, seed=2)[0], _clips(1, 1200, seed=3)[0]
    server = CodecServer(live, max_batch=8, max_wait_ms=1.0)
    futs = [server.submit('roundtrip', a), server.submit('roundtrip', b),
            server.submit('roundtrip', a, bandwidth=1.5), server.submit('encode', a)]
    server.start()
    try:
        r1, r2, r3, r4 = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        server.stop()
    assert r1.shape == (1, 2400) and r2.shape == (1, 1200) and r4[0].shape == (4, 8)
    np.testing.assert_allclose(r3, _direct(live, a, 1.5), atol=1e-6)
    assert server.stats()['batches'] == 4

    clips = _clips(4, 2400, seed=4) + _clips(4, 1200, seed=5)
    direct = [_direct(live, c) for c in clips]
    results = [None] * len(clips)
    with CodecServer(live, max_batch=4, max_wait_ms=20.0) as server:
        def call(i):
            results[i] = server.roundtrip(clips[i], timeout=TIMEOUT)
        _join_all([threading.Thread(target=call, args=(i,)) for i in range(len(clips))])
        s = server.stats()
    for out, ref in zip(results, direct):
        np.testing.assert_allclose(out, ref, atol=1e-6)
    assert s['requests'] == 8 and s['batches'] < 8


def test_server_error_propagates(live):
    with CodecServer(live, max_wait_ms=0.5) as server:
        fut = server.submit('roundtrip', np.zeros((3, 7, 5), np.float32))
        with pytest.raises(Exception):
            fut.result(timeout=TIMEOUT)
        out = server.roundtrip(_clips(1, 1200)[0], timeout=TIMEOUT)   # still serving
    assert out.shape == (1, 1200)
    with pytest.raises(ValueError, match='kind'):
        server.submit('stream', np.zeros((1, 10), np.float32))


def test_length_buckets_constant_exact(live_const):
    assert live_const.length_pad_exact and live_const.length_pad_min_samples == 0
    lengths = [1600, 2000, 2399, 2400, 800]
    clips = [_clips(1, t, seed=10 + i)[0] for i, t in enumerate(lengths)]
    direct = [_direct(live_const, c) for c in clips]
    codes = [live_const.encode(c[None])[0][0].numpy() for c in clips]
    server = CodecServer(live_const, max_batch=8, max_wait_ms=1.0, length_buckets=[2400])
    futs = [server.submit('roundtrip', c) for c in clips]
    cfuts = [server.submit('encode', c) for c in clips]
    server.start()
    try:
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        got_codes = [f.result(timeout=TIMEOUT)[0] for f in cfuts]
    finally:
        server.stop()
    for out, ref, c, rc, t in zip(outs, direct, got_codes, codes, lengths):
        assert out.shape == (1, t)
        np.testing.assert_allclose(out, ref, atol=1e-6)
        np.testing.assert_array_equal(c, rc)
    assert server.stats()['batches'] == 2


def test_length_buckets_reflect_tail_exact(live):
    assert not live.length_pad_exact and live.length_pad_tail_exact
    hop, m = live.hop_length, live.length_pad_min_samples
    assert m == 2240
    bucket = -(-(m + 480) // hop) * hop
    lengths = [m, m + 160, bucket - 1]
    clips = [_clips(1, t, seed=20 + i)[0] for i, t in enumerate(lengths)]
    direct = [_direct(live, c) for c in clips]
    server = CodecServer(live, max_batch=8, max_wait_ms=1.0, length_buckets=[bucket])
    futs = [server.submit('roundtrip', c) for c in clips]
    server.start()
    try:
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        server.stop()
    for out, ref, t in zip(outs, direct, lengths):
        cut = (-(-t // hop) - 1) * hop            # all but the final hop
        assert out.shape == (1, t)
        np.testing.assert_allclose(out[..., :cut], ref[..., :cut], atol=1e-6)
    assert server.stats()['batches'] == 1


def test_length_buckets_refused_for_normalizing_model():
    codec = LiveCodec(_model(normalize=True), device='cpu')
    assert not codec.length_pad_exact and not codec.length_pad_tail_exact
    with pytest.raises(ValueError, match='length_buckets'):
        CodecServer(codec, length_buckets=[2400])


# ----------------------------------------------------------- streaming server


@pytest.fixture(scope='module')
def stream_model():
    return _model()


def _signal(i, total):
    t = np.arange(total, dtype=np.float32)
    return (0.3 * np.sin(2 * np.pi * (80 + 40 * i) * t / 24000)).astype(np.float32)[None]


def _alone(model, sig, first, hop):
    """The signal through StreamingCodec alone, chunk by chunk: (wav, codes)."""
    codec = StreamingCodec(model)
    enc, dec = codec.init_state(1)
    outs, codes, pos = [], [], 0
    while pos < sig.shape[-1]:
        n = first if pos == 0 else hop
        y, c, enc, dec = codec.roundtrip_chunk(enc, dec, torch.from_numpy(sig[None, :, pos:pos + n]),
                                               first=(pos == 0))
        outs.append(y[0].numpy())
        codes.append(c[0].numpy())
        pos += n
    return np.concatenate(outs, -1), np.concatenate(codes, -1)


def test_streaming_server_matches_streaming_codec(stream_model):
    """3 streams (one joining late) through the masked batched step, each
    equal to StreamingCodec alone on its signal."""
    server = StreamingServer(stream_model, max_streams=4, chunk_hops=2, max_wait_ms=50.0,
                             device='cpu')
    first, hop = server.min_first_chunk_samples, server.chunk_samples
    n_steady = 4
    signals = [_signal(i, first + n_steady * hop) for i in range(3)]
    alone = [_alone(stream_model, s, first, hop) for s in signals]
    outputs = [None] * 3
    late_join = threading.Event()

    def run_stream(i):
        if i == 2:
            late_join.wait(timeout=TIMEOUT)
        with server.open_stream() as stream:
            outs = [stream.process(signals[i][:, :first], timeout=TIMEOUT, with_codes=True)]
            for k in range(n_steady):
                if i == 0 and k == 1:
                    late_join.set()
                a = first + k * hop
                outs.append(stream.process(signals[i][:, a:a + hop], timeout=TIMEOUT,
                                           with_codes=True))
            outputs[i] = tuple(np.concatenate(o, axis=-1) for o in zip(*outs))

    with server:
        _join_all([threading.Thread(target=run_stream, args=(i,)) for i in range(3)])
        stats = server.stats()
    for (wav, codes), (ref_wav, ref_codes) in zip(outputs, alone):
        np.testing.assert_array_equal(codes, ref_codes)
        np.testing.assert_allclose(wav, ref_wav, atol=2e-5, rtol=1e-5)
    assert stats['joins'] == 3 and stats['chunks'] == 3 * (1 + n_steady)
    assert stats['ticks'] < stats['chunks'] and 'tick_ms_p50' in stats


def test_streaming_server_slots_reuse_and_recovery(stream_model):
    server = StreamingServer(stream_model, max_streams=2, chunk_hops=1, max_wait_ms=1.0,
                             device='cpu')
    first, hop = server.min_first_chunk_samples, server.chunk_samples
    a, b = _signal(0, first + 2 * hop), _signal(5, first + 2 * hop)
    ref_b, _ = _alone(stream_model, b, first, hop)

    real_mux = server._mux
    boom = {'armed': False}

    def flaky(*args):
        if boom.pop('armed', False):
            raise RuntimeError('injected device failure')
        return real_mux(*args)
    server._mux = flaky

    with server:
        s1, s2 = server.open_stream(), server.open_stream()
        with pytest.raises(RuntimeError, match='slots'):
            server.open_stream()
        s2.close()
        s1.process(a[:, :first], timeout=TIMEOUT)
        s1.process(a[:, first:first + hop], timeout=TIMEOUT)
        with pytest.raises(ValueError, match='steady chunks'):
            s1.process(a[:, :2 * hop], timeout=TIMEOUT)
        slot = s1.slot
        s1.close()
        with pytest.raises(RuntimeError, match='closed'):
            s1.process(a[:, :first], timeout=TIMEOUT)

        s3 = server.open_stream()                  # the same slot, fresh state
        assert s3.slot == slot
        outs = [s3.process(b[:, :first], timeout=TIMEOUT)]
        outs += [s3.process(b[:, first + k * hop:first + (k + 1) * hop], timeout=TIMEOUT)
                 for k in range(2)]
        s3.close()
        np.testing.assert_allclose(np.concatenate(outs, -1), ref_b, atol=2e-5, rtol=1e-5)

        s4 = server.open_stream()
        s4.process(a[:, :first], timeout=TIMEOUT)
        boom['armed'] = True
        with pytest.raises(RuntimeError, match='injected'):
            s4.process(a[:, first:first + hop], timeout=TIMEOUT)
        assert s4.closed and server.stats()['resets'] == 1

        s5 = server.open_stream()                  # serves again after the reset
        outs = [s5.process(b[:, :first], timeout=TIMEOUT)]
        outs += [s5.process(b[:, first + k * hop:first + (k + 1) * hop], timeout=TIMEOUT)
                 for k in range(2)]
        s5.close()
    np.testing.assert_allclose(np.concatenate(outs, -1), ref_b, atol=2e-5, rtol=1e-5)

    with pytest.raises(ValueError, match='max_streams'):
        StreamingServer(stream_model, max_streams=1, device='cpu')


def test_streaming_server_int8(stream_model):
    """The int8 twin through the multiplexer equals the twin's offline
    forward (its weights dequantized, the same f32 arithmetic)."""
    qmodel = prepare.prepare_for_inference(stream_model, 'int8')
    server = StreamingServer(qmodel, max_streams=2, chunk_hops=1, max_wait_ms=1.0,
                             device='cpu')
    first, hop = server.min_first_chunk_samples, server.chunk_samples
    sig = _signal(3, first + 3 * hop)
    offline = prepare.quantized_call(qmodel, torch.from_numpy(sig[None]))[0].numpy()
    with server:
        with server.open_stream() as stream:
            outs = [stream.process(sig[:, :first], timeout=TIMEOUT)]
            outs += [stream.process(sig[:, first + k * hop:first + (k + 1) * hop],
                                    timeout=TIMEOUT) for k in range(3)]
    np.testing.assert_allclose(np.concatenate(outs, -1), offline, atol=2e-5, rtol=1e-5)


def test_streaming_server_inflight_chunks_never_hang(stream_model):
    server = StreamingServer(stream_model, max_streams=2, device='cpu')
    chunk = _signal(0, server.min_first_chunk_samples)
    for stop in (False, True):          # close() of the stream, then stop() of the server
        s = server.open_stream()
        err = [None]

        def call():
            try:
                s.process(chunk, timeout=TIMEOUT)
            except RuntimeError as e:
                err[0] = e
        t = threading.Thread(target=call)
        t.start()
        while s.slot not in server._pending and t.is_alive():
            t.join(timeout=0.01)
        server.stop() if stop else s.close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        assert ('stopped' if stop else 'in flight') in str(err[0])
    with pytest.raises(RuntimeError, match='stopped'):
        s.process(chunk, timeout=TIMEOUT)


def test_servers_refuse_without_a_card(stream_model, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamingServer(stream_model)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LiveCodec(stream_model)
