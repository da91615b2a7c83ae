"""Serving preparation (``prepare.py``) in the port, on the CPU: weight-norm
folding and int8 weight-only weights.

- The folded conv weights equal the JAX package's ``fold_weight_norm_params``
  on the same ``(v, g)`` within 1e-6 of max|ref|: both compute
  ``g · v / ‖v‖`` in f32, so they differ by a few ULPs of the sum's order
  across frameworks, not by method.
- In the port, folding is invisible: codes, decoded audio and ``.ecdc``
  bytes of the folded model are bit-identical to the raw model's (it
  evaluates once the torch expression the raw model evaluates per call).
- ``cli --weights fold`` round trips at full ``encodec_24khz`` width and
  writes the raw CLI's bytes; ``LiveCodec(weights='fold')`` and a
  ``CodecServer`` over it return the raw codec's results.
- A ``time_group_norm`` model cannot fold (``ValueError``), nor be
  quantized; ``LiveCodec(weights='int8')`` builds and serves the int8 twin
  (as does a ``CodecServer`` over it), and an unknown ``weights`` raises
  ``ValueError``.

int8 (``quantize_weights`` and what runs on its twin), against the JAX
package on the same folded weights. The two packages' folds differ by a few
ULPs (above), so the int8 twin under test quantizes the JAX fold loaded into
the port:

- its ``q8`` and ``scale`` are bit-equal to the JAX ``quantize_weights`` of
  that fold, for every conv, transposed conv, 1×1 and LSTM matrix (a
  transposed conv's and an LSTM matrix's named, whose JAX trailing axis is
  dim 0 of torch's layout); the dequantized weights are within the JAX
  test's bound ``max|w| / 254`` a channel; the weights take under 0.35 of
  the fold's bytes (``tests/test_prepare.py``'s bar);
- a JAX int8 tree carried by ``convert.state_dict_from_jax`` loads strictly
  into the twin and gives its weights bit for bit;
- on the twin, the port's ``quantized_call`` matches the JAX
  ``quantized_call`` in f32 (1e-5 of max|ref|) and the port's ``LiveCodec``
  the JAX ``LiveCodec`` on the int8 variables (codes exact, audio 1e-5 of
  max|ref|); in bf16 the two ``quantized_call`` outputs are within the bf16
  codec gate of ``tests/test_torch_bf16.py`` (relative RMS < 0.15) and apart
  from the f32 output;
- the twin's blocks and LSTM route to the int8 entries of K3 and K2 (plain
  versions here) while they dequantize in f32, and their plain versions are
  the f32 plain versions on the dequantized weights, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu import prepare as jprepare
from encodec_pytorch_tpu import serve as jserve
from encodec_pytorch_tpu.models.model import EncodecModel as JaxModel
from encodec_pytorch_tpu.models.model import variables_from_torch_state_dict
from encodec_pytorch_tpu_torch import cli, convert
from encodec_pytorch_tpu_torch import compress as TC
from encodec_pytorch_tpu_torch import prepare
from encodec_pytorch_tpu_torch.models.model import EncodecModel, encodec_model_24khz
from encodec_pytorch_tpu_torch.models.seanet import SEANetResnetBlock
from encodec_pytorch_tpu_torch.ops import lstm_kernel, resblock_kernel
from encodec_pytorch_tpu_torch.ops.int8 import dequantize_int8, quantize_int8
from encodec_pytorch_tpu_torch.prepare import fold_weight_norm
from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec
from encodec_pytorch_tpu_torch.utils import read_wav, write_wav
from test_torch_disc import close

torch.set_num_threads(1)

TINY = dict(target_bandwidths=[1.5, 3., 6.], sample_rate=24000, channels=1, causal=True,
            model_norm='weight_norm', name='encodec_24khz', n_q=8, n_filters=4)


def _with_codebooks(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.quantizer.vq.layers:
            layer._codebook.embed.normal_(generator=gen)
            layer._codebook.inited.fill_(1.)
    return model


@pytest.fixture(scope='module')
def raw():
    model = EncodecModel._get_model(generator=torch.Generator().manual_seed(3), **TINY)
    model = _with_codebooks(model, 4).eval()
    model.set_target_bandwidth(6.)
    return model


def _clip(length, seed):
    return (np.random.default_rng(seed).standard_normal((1, length)) * 0.1).astype(np.float32)


@pytest.fixture(scope='module')
def jax_fold(raw):
    """``raw``'s weights in the JAX package, and its ``fold_weight_norm`` of
    them (``fold_weight_norm_params``, eager as the package calls it):
    (folded JAX model, folded variables)."""
    jm = JaxModel._get_model(audio_normalize=False, segment=None, **TINY)
    jm.set_target_bandwidth(6.)
    sd = {k: v.numpy() for k, v in raw.state_dict().items()}
    variables = jax.device_get(variables_from_torch_state_dict(jm, sd))
    jfold, jvars = jprepare.fold_weight_norm(jm, variables)
    return jfold, jax.device_get(jvars)


def test_fold_matches_jax(raw, jax_fold):
    jvars = jax_fold[1]
    ref = convert.state_dict_from_jax({'params': jvars['params'],
                                       'quantizer': jvars['quantizer']})
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = fold_weight_norm(raw).state_dict()
    assert set(got) == set(ref)
    assert not any(k.endswith(('weight_v', 'weight_g')) for k in got)
    for k, v in got.items():
        close(v.numpy(), ref[k], rel=1e-6)


def test_folded_codes_decode_and_bytes_are_bit_identical(raw):
    folded = fold_weight_norm(raw)
    assert (folded.name, folded.bandwidth) == (raw.name, raw.bandwidth)
    assert all(torch.equal(a, b) for a, b in zip(folded.quantizer.state_dict().values(),
                                                 raw.quantizer.state_dict().values()))
    x = torch.from_numpy(_clip(5000, 1)[None])
    codes_raw, codes_fold = raw.encode(x), folded.encode(x)
    assert torch.equal(codes_raw[0][0], codes_fold[0][0])
    assert torch.equal(raw.decode(codes_raw), folded.decode(codes_fold))
    assert TC.compress(raw, _clip(5000, 1)) == TC.compress(folded, _clip(5000, 1))
    for block_raw, block_fold in zip(raw.encoder.model, folded.encoder.model):
        if hasattr(block_raw, 'fused_weights'):       # K3's weights, as the card reads them
            assert all(torch.equal(a, b) for a, b in zip(block_raw.fused_weights(),
                                                         block_fold.fused_weights()))


def test_live_codec_fold_and_refusals(raw):
    live_raw = LiveCodec(raw, device='cpu')
    live_fold = LiveCodec(raw, weights='fold', device='cpu')
    assert live_fold.model is not raw and live_fold.model.name == raw.name
    clips = [_clip(3200, 10 + i) for i in range(3)]
    with CodecServer(live_fold, max_batch=4, max_wait_ms=1.0) as server:
        for clip in clips:
            want = live_raw.roundtrip(clip[None])[0].numpy()
            np.testing.assert_array_equal(live_fold.roundtrip(clip[None])[0].numpy(), want)
            np.testing.assert_array_equal(server.roundtrip(clip, timeout=60), want)
    live_int8 = LiveCodec(raw, weights='int8', device='cpu')    # builds and serves the twin
    assert live_int8.model.name == raw.name and live_int8.model.encoder.model[0].conv.conv.int8
    with CodecServer(live_int8, max_batch=4, max_wait_ms=1.0) as server:
        for clip in clips[:2]:
            want = prepare.quantized_call(live_int8.model, torch.from_numpy(clip[None]))
            np.testing.assert_array_equal(live_int8.roundtrip(clip[None]).numpy(), want.numpy())
            np.testing.assert_array_equal(server.roundtrip(clip, timeout=60), want[0].numpy())
    with pytest.raises(ValueError, match="'raw', 'fold'"):
        LiveCodec(raw, weights='half', device='cpu')
    tgn = EncodecModel._get_model([6.], 24000, 1, causal=False, model_norm='time_group_norm',
                                  audio_normalize=True, n_q=2, n_filters=4)
    with pytest.raises(ValueError, match='weight_norm'):
        fold_weight_norm(tgn)
    with pytest.raises(ValueError, match='weight_norm'):
        LiveCodec(tgn, weights='fold', device='cpu')
    with pytest.raises(ValueError, match='weight_norm'):
        LiveCodec(tgn, weights='int8', device='cpu')
    with pytest.raises(ValueError, match='folded'):
        prepare.quantize_weights(tgn)
    with pytest.raises(ValueError, match='folded'):
        prepare.quantize_weights(raw)            # fold first


def test_cli_weights_fold(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = encodec_model_24khz(device='cpu', generator=torch.Generator().manual_seed(5))
    torch.save(_with_codebooks(model, 6).state_dict(), tmp_path / 'seeded.th')
    write_wav(tmp_path / 'in.wav', _clip(9600, 2), 24000)
    common = ['-m', 'encodec_24khz', '-c', 'seeded.th', '-b', '6', '--device', 'cpu', '-f']
    cli.main(['in.wav', 'raw.ecdc', *common])
    cli.main(['in.wav', 'fold.ecdc', *common, '--weights', 'fold'])
    assert (tmp_path / 'raw.ecdc').read_bytes() == (tmp_path / 'fold.ecdc').read_bytes()
    cli.main(['fold.ecdc', 'fold.wav', *common, '--weights', 'fold'])
    cli.main(['raw.ecdc', 'raw.wav', *common])
    out, sr = read_wav(tmp_path / 'fold.wav')
    assert sr == 24000 and out.shape == (1, 9600) and np.isfinite(out).all()
    assert np.array_equal(out, read_wav(tmp_path / 'raw.wav')[0])


# ----------------------------------------------------------------- int8


@pytest.fixture(scope='module')
def int8(raw, jax_fold):
    """The JAX fold of ``raw``'s weights and its JAX int8 tree (eager
    ``quantize_weights``, as ``prepare_for_inference`` calls it; jitted, XLA
    rounds some scales differently); the port's int8 twin of that fold
    (``quantize_weights``); the twin with the JAX int8 tree loaded
    strictly."""
    jfold, jvars = jax_fold
    qparams = jax.device_get(jprepare.quantize_weights(jvars['params']))
    folded = fold_weight_norm(raw)
    folded.load_state_dict(convert.state_dict_from_jax(jvars), strict=True)
    twin = prepare.quantize_weights(folded)
    carried = prepare.quantize_weights(fold_weight_norm(raw))
    carried.load_state_dict(convert.state_dict_from_jax(dict(jvars, params=qparams)),
                            strict=True)
    return jfold, dict(jvars, params=qparams), folded, twin, carried


def test_quantize_matches_jax_bit_for_bit(int8):
    _, qvars, folded, twin, _ = int8
    ref = convert.state_dict_from_jax(qvars)
    got = twin.state_dict()
    assert set(got) == set(ref)
    q8 = [k for k in got if k.endswith('_q8')]
    paths = jax.tree_util.tree_flatten_with_path(qvars['params'])[0]
    assert len(q8) == sum(path[-1].key == 'q8' for path, _ in paths) > 30
    # the axis trap: the JAX layouts' trailing axis is dim 0 of torch's
    for key in ('decoder.model.3.convtr.convtr.weight', 'encoder.model.13.lstm.weight_hh_l1',
                'decoder.model.1.lstm.weight_ih_l0', 'encoder.model.1.block.1.conv.conv.weight'):
        assert got[f'{key}_q8'].dtype == torch.int8
        assert got[f'{key}_scale'].shape == got[f'{key}_q8'].shape[:1]
    for k, v in got.items():
        assert v.dtype == ref[k].dtype and torch.equal(v, ref[k]), k
    weights = folded.state_dict()
    for k in q8:
        w = weights[k[:-3]]
        amax = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
        err = (dequantize_int8(got[k], got[k[:-3] + '_scale']) - w).abs()
        assert float((err - amax / 254).max()) <= 1e-6, k
    assert prepare.param_bytes(twin) < 0.35 * prepare.param_bytes(folded)


def test_jax_int8_tree_loads_strictly(int8):
    _, _, _, twin, carried = int8
    got, want = carried.state_dict(), twin.state_dict()
    assert all(torch.equal(v, want[k]) and v.dtype == want[k].dtype for k, v in got.items())
    x = torch.from_numpy(_clip(4800, 7)[None])
    assert torch.equal(prepare.quantized_call(carried, x), prepare.quantized_call(twin, x))


def test_int8_twin_matches_jax_quantized_call_and_live_codec(int8):
    """The port's ``quantized_call`` and its ``LiveCodec`` on the twin
    against the JAX ``quantized_call`` (the forward: encode, quantize,
    decode) and the JAX ``LiveCodec``'s encode on the int8 variables."""
    jfold, qvars, _, twin, _ = int8
    x = _clip(4800, 8)[None]
    ref = np.asarray(jprepare.quantized_call(jfold, qvars, jnp.asarray(x)))
    got = prepare.quantized_call(twin, torch.from_numpy(x))
    close(got.numpy(), ref)
    live = LiveCodec(twin, device='cpu')
    codes = live.encode(x, bandwidth=6.)
    np.testing.assert_array_equal(codes[0].numpy(),
                                  np.asarray(jserve.LiveCodec(jfold, qvars).encode(x)[0]))
    np.testing.assert_array_equal(live.decode(codes, bandwidth=6.).numpy(), got.numpy())


def test_int8_quantized_call_in_bf16_matches_jax(raw):
    """A bf16 model's twin dequantizes in bf16 (the model's dtype) in
    ``quantized_call``, the LSTM's matrices too before its f32 up-cast."""
    jm = JaxModel._get_model(audio_normalize=False, segment=None, dtype=jnp.bfloat16, **TINY)
    jm.set_target_bandwidth(6.)
    variables = jax.device_get(variables_from_torch_state_dict(
        jm, {k: v.numpy() for k, v in raw.state_dict().items()}))
    jfold, jvars = jprepare.fold_weight_norm(jm, variables)
    qvars = dict(jvars, params=jax.device_get(jprepare.quantize_weights(jvars['params'])))
    port = EncodecModel._get_model(dtype=torch.bfloat16, **TINY).eval()
    port.set_target_bandwidth(6.)
    twin = prepare.quantize_weights(fold_weight_norm(port))
    twin.load_state_dict(convert.state_dict_from_jax(qvars), strict=True)
    x = _clip(4800, 9)[None]
    got = prepare.quantized_call(twin, torch.from_numpy(x)).numpy()
    ref = np.asarray(jprepare.quantized_call(jfold, qvars, jnp.asarray(x)))
    f32 = prepare.quantized_call(twin, torch.from_numpy(x), dtype=torch.float32).numpy()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))   # noqa: E731
    assert got.dtype == np.float32 and rms(got - ref) / rms(ref) < 0.15
    assert not np.array_equal(got, f32)
    assert all(m.dequant_dtype == torch.float32 for m in prepare._holders(twin))   # restored


def test_int8_twin_routes_to_the_int8_kernel_entries(raw, monkeypatch):
    """The routing a card run takes, with K3's and K2's int8 entries spied on
    (their plain versions run here): blocks and the LSTM take them while the
    twin dequantizes in f32; in bf16 they take the conv sequence and K2's f32
    entry. ``fused_weights`` gives the int8 weights and their scales, cached."""
    twin = prepare.quantize_weights(fold_weight_norm(raw))
    blocks = [m for m in twin.modules() if isinstance(m, SEANetResnetBlock)]
    w = blocks[0].fused_weights()
    assert [t.dtype for t in w[::3]] == [torch.int8] * 3 and blocks[0].fused_weights() is w
    calls = dict.fromkeys(('resblock', 'resblock_int8', 'lstm_recurrence_int8'), 0)
    for mod, name in ((resblock_kernel, 'resblock'), (resblock_kernel, 'resblock_int8'),
                      (lstm_kernel, 'lstm_recurrence_int8')):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    for blk in blocks:       # as on the card: K3 wherever the block takes the kernel
        monkeypatch.setattr(blk, 'takes_kernel',
                            lambda device_type, b=blk: SEANetResnetBlock.takes_kernel(b, 'cuda'))
    x = torch.from_numpy(_clip(3200, 11)[None])
    with torch.no_grad():
        sequence = twin.decode(twin.encode(x))
    assert calls == dict(resblock=0, resblock_int8=8, lstm_recurrence_int8=4)
    for blk in blocks:
        monkeypatch.setattr(blk, 'takes_kernel', SEANetResnetBlock.takes_kernel.__get__(blk))
    close(twin.decode(twin.encode(x)).numpy(), sequence.numpy())   # fused = conv sequence
    calls.update(dict.fromkeys(calls, 0))
    with prepare.dequantizing_in(twin, torch.bfloat16):
        assert not any(b.takes_fused() for b in blocks)
        assert twin.encoder.model[0].conv.conv.kernel().dtype == torch.bfloat16
        prepare.quantized_call(twin, x, dtype=torch.bfloat16)
    assert calls == dict.fromkeys(calls, 0)


def test_int8_plain_versions_are_the_f32_ones_on_dequantized_weights():
    gen = torch.Generator().manual_seed(12)
    H, B, T = 24, 3, 9
    q8, scale = quantize_int8(torch.randn(4 * H, H, generator=gen) / H ** 0.5)
    xp = torch.randn(T, B, 4 * H, generator=gen)
    h0, c0 = torch.randn(B, H, generator=gen), torch.randn(B, H, generator=gen)
    want = lstm_kernel.lstm_recurrence_reference(xp, dequantize_int8(q8, scale), h0, c0)
    for got in (lstm_kernel.lstm_recurrence_int8_reference(xp, q8, scale, h0, c0),
                lstm_kernel.lstm_recurrence_int8(xp, q8, scale, h0, c0)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    C = 12
    ws = [quantize_int8(torch.randn(*shape, generator=gen)) for shape in
          ((C // 2, C, 3), (C, C // 2), (C, C))]
    b = [torch.randn(n, generator=gen) for n in (C // 2, C, C)]
    args8 = (ws[0][0], ws[0][1], b[0], ws[1][0], ws[1][1], b[1], ws[2][0], ws[2][1], b[2])
    args32 = (dequantize_int8(*ws[0]), b[0], dequantize_int8(*ws[1]), b[1],
              dequantize_int8(*ws[2]), b[2])
    x, left = torch.randn(2, C, 40, generator=gen), torch.randn(2, C, 4, generator=gen)
    kw = dict(dilation=2, causal=True, left=left, return_carry=True)
    want = resblock_kernel.resblock_reference(x, *args32, **kw)
    for got in (resblock_kernel.resblock_int8_reference(x, *args8, **kw),
                resblock_kernel.resblock_int8(x, *args8, **kw)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
