"""The port's host arithmetic coder and kernel K6's plain version against the
JAX package on the CPU.

Same pdfs and symbols (numpy-seeded) through the JAX package's ``ac.py``
coder, its on-device ``make_fused_ac_only`` program (run on the CPU backend),
the port's Python coder (``bitstream/ac.py``), its C++ coder
(``bitstream/native.py``) and the plain version of K6
(``ops/lm_coder_kernel.py``). Bars: bytes exactly equal; every decoder
returns the symbols; CDFs bit-equal; a truncated stream ends the host
decoders (``None``, a short batch) and sets K6's ``overrun``; the CDF pairs
of K6's encode pass (its plain version) equal the JAX device build gathered
at the symbols, and its CDFs equal that build's on pdfs outside [0, 1]. Cases: random
pdfs at card 16, 200 and 1024; skewed pdfs (Dirichlet 0.02) with symbols
drawn from their tails; one-hot pdfs with the symbols at both edges and on
the hot bin, and a uniform pdf; K 1, 3 and 8 symbols a step.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu.bitstream import ac as jax_ac
from encodec_pytorch_tpu.bitstream import binary as jax_binary
from encodec_pytorch_tpu.bitstream import fused as jax_fused
from encodec_pytorch_tpu_torch.bitstream import ac, binary, native
from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as K6

torch.set_num_threads(1)


def _random(card, n, seed, alpha=0.25, tails=False):
    rng = np.random.default_rng(seed)
    pdfs = rng.dirichlet(np.full(card, alpha), size=n).astype(np.float32)
    if tails:    # the least likely bins of each pdf
        syms = np.array([rng.choice(np.argsort(p)[:max(1, card // 8)]) for p in pdfs])
    else:
        syms = np.array([rng.choice(card, p=p / p.sum()) for p in pdfs])
    return pdfs, syms.astype(np.int32)


def _edge(card=64):
    pdfs, syms = [], []
    for i in range(60):
        p = np.full(card, 1e-9, np.float32)
        p[i % card] = 1.0
        pdfs.append(p / p.sum())
        syms.append([0, card - 1, i % card][i % 3])
    pdfs.append(np.full(card, 1.0 / card, np.float32))
    syms.append(card // 2)
    return np.stack(pdfs).astype(np.float32), np.asarray(syms, np.int32)


CASES = {
    'random16': lambda: _random(16, 40, 0),
    'random200': lambda: _random(200, 97, 1),
    'random1024': lambda: _random(1024, 64, 2),
    'skewed1024': lambda: _random(1024, 48, 3, alpha=0.02, tails=True),
    'edge64': _edge,
}


def _jax_host_encode(pdfs, syms):
    fo = io.BytesIO()
    coder = jax_ac.ArithmeticCoder(fo)
    for p, s in zip(pdfs, syms):
        coder.push(int(s), jax_ac.build_stable_quantized_cdf(p, 24, check=False))
    coder.flush()
    return fo.getvalue()


def _port_host_encode(pdfs, syms):
    fo = io.BytesIO()
    coder = ac.ArithmeticCoder(fo)
    for p, s in zip(pdfs, syms):
        coder.push(int(s), ac.build_stable_quantized_cdf(p, 24, check=False))
    coder.flush()
    return fo.getvalue()


def _port_host_decode(data, pdfs):
    dec = ac.ArithmeticDecoder(io.BytesIO(data))
    return [dec.pull(ac.build_stable_quantized_cdf(p, 24, check=False)) for p in pdfs]


def _native_encode(pdfs, syms):
    enc = native.NativeAcEncoder(24)
    enc.push_batch(syms, native.build_cdf_batch(pdfs))
    return enc.finish()


def _k6_encode(pdfs, syms, K):
    n, card = pdfs.shape
    coder = K6.init_state()
    bits = torch.zeros(K6.stream_bytes(K6.bits_capacity(n)), dtype=torch.uint8)
    K6.lm_coder(torch.from_numpy(pdfs).view(n // K, K, card),
                torch.from_numpy(syms).view(n // K, K), coder, bits, decode=False, finish=True)
    assert coder[K6.OVERFLOW] == 0
    return bits[:K6.stream_bytes(int(coder[K6.BIT_POS]))].numpy().tobytes()


def _k6_decode(data, pdfs, K):
    """One call a step of K symbols, as the fused decoder calls it."""
    n, card = pdfs.shape
    coder = K6.init_state()
    buf = np.zeros(K6.stream_bytes(K6.bits_capacity(n)), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    bits = torch.from_numpy(buf)
    syms = torch.zeros(n // K, K, dtype=torch.int32)
    p = torch.from_numpy(pdfs).view(n // K, K, card)
    for t in range(n // K):
        K6.lm_coder(p[t:t + 1], syms[t:t + 1], coder, bits, decode=True, n_bits_in=8 * len(data))
    return syms.view(-1).numpy(), int(coder[K6.OVERRUN])


def test_native_coder_builds():
    assert native.available(), 'g++ should build the native coder here'


def test_bitpacker_matches_jax():
    rng = np.random.default_rng(4)
    for bits in (1, 10):
        values = rng.integers(0, 2 ** bits, 77)
        ours, ref = io.BytesIO(), io.BytesIO()
        p, r = binary.BitPacker(bits, ours), jax_binary.BitPacker(bits, ref)
        for v in values:
            p.push(int(v))
            r.push(int(v))
        p.flush()
        r.flush()
        assert ours.getvalue() == ref.getvalue()
        un = binary.BitUnpacker(bits, io.BytesIO(ours.getvalue()))
        assert [un.pull() for _ in values] == list(values)


@pytest.mark.parametrize('case', sorted(CASES))
def test_cdf_builds_bit_equal(case):
    pdfs, _ = CASES[case]()
    ref = np.stack([jax_ac.build_stable_quantized_cdf(p, 24, check=False) for p in pdfs])
    ours = np.stack([ac.build_stable_quantized_cdf(p, 24, check=False) for p in pdfs])
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(native.build_cdf_batch(pdfs), ref)
    np.testing.assert_array_equal(K6.build_cdf(torch.from_numpy(pdfs)).numpy(), ref)
    dev = np.asarray(jax_fused.build_cdf_device(jnp.asarray(pdfs)))
    np.testing.assert_array_equal(dev.astype(np.int64), ref)


@pytest.mark.parametrize('case', sorted(CASES))
def test_k6_cdf_pairs_equal_jax_cdf_at_the_symbols(case):
    """The plain version of K6's encode pass 1, ``(cdf[sym - 1], cdf[sym])``
    of each row, against the JAX ``build_cdf_device`` gathered at the symbols;
    a symbol outside the card takes symbol 0's pair."""
    pdfs, syms = CASES[case]()
    syms = syms.copy()
    syms[-1] = pdfs.shape[1]
    dev = np.asarray(jax_fused.build_cdf_device(jnp.asarray(pdfs))).astype(np.int64)
    at = np.where(syms < pdfs.shape[1], syms, 0)
    rows = np.arange(len(syms))
    want = np.stack([np.where(at > 0, dev[rows, np.maximum(at - 1, 0)], 0), dev[rows, at]], -1)
    got = K6.cdf_pairs_reference(torch.from_numpy(pdfs)[:, None], torch.from_numpy(syms)[:, None])
    np.testing.assert_array_equal(got[:, 0].numpy(), want)


def test_k6_plain_cdf_equals_jax_outside_0_1():
    """The plain version of K6's CDF build on pdfs with bins outside [0, 1]
    (-0.0, negative, above 1, past the int32 range, infinite, NaN) against
    the JAX ``build_cdf_device``: each range converted to int32 saturating
    (NaN to 0) and the sums wrapping at 32 bits, as K6 builds them; and its
    CDF pairs gathered from it."""
    rng = np.random.default_rng(4)
    pdfs = rng.dirichlet(np.full(64, 0.25), size=16).astype(np.float32)
    odd = np.float32([-0.0, -0.25, 1.5, 3.0, 200.0, np.inf, -np.inf, np.nan])
    for row in pdfs:
        row[rng.choice(64, 3, replace=False)] = rng.choice(odd, 3)
    want = np.asarray(jax_fused.build_cdf_device(jnp.asarray(pdfs))).astype(np.int64)
    got = K6.build_cdf_reference(torch.from_numpy(pdfs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want < 0).any() and (np.diff(want, axis=1) <= 0).any()
    syms = rng.integers(0, 64, 16).astype(np.int32)
    pairs = K6.cdf_pairs_reference(torch.from_numpy(pdfs), torch.from_numpy(syms)).numpy()
    rows = np.arange(16)
    np.testing.assert_array_equal(pairs[:, 1], want[rows, syms])
    np.testing.assert_array_equal(pairs[:, 0], np.where(syms > 0, want[rows, syms - 1], 0))


@pytest.mark.parametrize('case', sorted(CASES))
def test_host_coders_bytes_equal_jax(case):
    pdfs, syms = CASES[case]()
    ref = _jax_host_encode(pdfs, syms)
    assert _port_host_encode(pdfs, syms) == ref
    assert _native_encode(pdfs, syms) == ref
    assert _port_host_decode(ref, pdfs) == list(syms)
    dec = native.NativeAcDecoder(ref, 24)
    np.testing.assert_array_equal(dec.pull_batch(native.build_cdf_batch(pdfs)), syms)


@pytest.mark.parametrize('case', sorted(CASES))
def test_k6_plain_bytes_equal_host_and_fused_ac_only(case):
    pdfs, syms = CASES[case]()
    n, card = pdfs.shape
    ref = _jax_host_encode(pdfs, syms)
    fn = jax_fused.make_fused_ac_only(card)
    cap = jax_fused.bits_capacity(n)
    _, bits, n_bits, _ = fn(jnp.asarray(True), jnp.asarray(pdfs), jnp.asarray(syms),
                            jnp.zeros((cap,), jnp.int8), jnp.int32(0))
    fused = np.packbits(np.asarray(bits[:int(n_bits)]).astype(np.uint8),
                        bitorder='little').tobytes()
    assert fused == ref
    for K in (1, 3, 8):
        m = n - n % K
        ref_m = _jax_host_encode(pdfs[:m], syms[:m])
        assert _k6_encode(pdfs[:m], syms[:m], K) == ref_m, K
        got, overrun = _k6_decode(ref_m, pdfs[:m], K)
        np.testing.assert_array_equal(got, syms[:m])
        assert overrun == 0


def test_truncated_streams_end_every_decoder():
    pdfs, syms = CASES['random1024']()
    data = _jax_host_encode(pdfs, syms)[:20]
    assert None in _port_host_decode(data, pdfs)
    dec = native.NativeAcDecoder(data, 24)
    assert len(dec.pull_batch(native.build_cdf_batch(pdfs))) < len(syms)
    _, overrun = _k6_decode(data, pdfs, 8)
    assert overrun == 1


def test_k6_plain_state_carries_across_calls():
    """Encoding in pieces (a step a call, finish at the end) writes the bytes
    of one call over all steps."""
    pdfs, syms = CASES['random200']()
    m = len(syms) - len(syms) % 4
    p = torch.from_numpy(pdfs[:m]).view(-1, 4, pdfs.shape[1])
    s = torch.from_numpy(syms[:m]).view(-1, 4)
    coder = K6.init_state()
    bits = torch.zeros(K6.stream_bytes(K6.bits_capacity(m)), dtype=torch.uint8)
    for t in range(p.shape[0]):
        K6.lm_coder(p[t:t + 1], s[t:t + 1], coder, bits, decode=False,
                    finish=t == p.shape[0] - 1)
    data = bits[:K6.stream_bytes(int(coder[K6.BIT_POS]))].numpy().tobytes()
    assert data == _jax_host_encode(pdfs[:m], syms[:m])


def test_k6_plain_flags_a_symbol_outside_the_card():
    pdfs, syms = CASES['random16']()
    syms = syms.copy()
    syms[5] = 16
    coder = K6.init_state()
    bits = torch.zeros(K6.stream_bytes(K6.bits_capacity(len(syms))), dtype=torch.uint8)
    K6.lm_coder(torch.from_numpy(pdfs)[:, None], torch.from_numpy(syms)[:, None], coder, bits,
                decode=False, finish=True)
    assert coder[K6.OVERFLOW] == 1
