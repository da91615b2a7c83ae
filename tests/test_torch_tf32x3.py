"""The 3xTF32 numerics of kernel K4 (``csrc/disc_conv.cu``), on the CPU.

K4 splits each f32 operand into two TF32 parts and sums three TF32 products
a term. These tests hold the pieces of that decision that run without a
card: the wrapper's splitting function (integer bit operations emulating
``cvt.rna.tf32.f32``), the fragment order that ``pack_weight`` writes (read
back through the layout its docstring states, index by index), and a 3xTF32
emulation of the forward and the input-gradient correlation, with operands
split by that function and the products summed in float64, against the
float64 ``F.conv2d`` at a reduced discriminator shape (B 2, 32 channels, 3×9
taps at F-stride 2, T dilation 4, a ragged F): within 1e-5 of max|ref|.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck

# the discriminator's conv_3 of a scale, cut to B 2 and a ragged F (45 bins)
SHAPE = dict(B=2, C=32, T=13, F=45)
KERNEL, STRIDE, DILATION, PADDING = (3, 9), (1, 2), (4, 1), (4, 4)


def _data(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (SHAPE['B'], SHAPE['C'], SHAPE['T'], SHAPE['F'])).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, SHAPE['C'], *KERNEL))
                          / np.sqrt(SHAPE['C'] * 27)).astype(np.float32))
    return x, w


def test_split_tf32_rounds_to_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000),
                        [0.0, -0.0, 1.0, -1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12,
                         3.4e38]]).astype(np.float32)
    t = torch.from_numpy(v)
    hi, lo = dck.split_tf32(t)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert not bool((part.view(torch.int32) & 0x1FFF).any())   # 13 low bits zero
    v64, hi64, lo64 = (a.double() for a in (t, hi, lo))
    assert bool(((hi64 + lo64 - v64).abs() <= 2.0 ** -22 * v64.abs()).all())
    # round to nearest, ties away from zero: 1 + 2^-11 is half an ulp of TF32 at 1
    assert float(hi[-3]) == 1 + 2 ** -10 and float(lo[-3]) == -2 ** -11
    assert float(hi[-2]) == 1 + 2 ** -10           # 1 + 3·2^-12 rounds up
    # the exact bits of round-to-nearest-away on the 13 dropped bits
    bits = t.view(torch.int32).numpy().astype(np.int64)
    mag = bits & 0x7FFFFFFF
    want = np.where(bits < 0, -1, 1) * (((mag + 0x1000) >> 13) << 13)
    got = hi.view(torch.int32).numpy().astype(np.int64)
    assert np.array_equal(np.where(got < 0, -1, 1) * (got & 0x7FFFFFFF), want)


def _unpack(packed, C, KT, NJ, O):
    """``(hi, lo) [P, C, KT, NJ, O]`` read back from ``pack_weight``'s layout
    as its docstring states it, one element at a time."""
    P = packed.shape[0]
    packed = packed.numpy()
    hi = torch.zeros(P, C, KT * NJ, O, dtype=torch.float64)
    lo = torch.zeros_like(hi)
    _, tiles, chunks, steps, frags, lanes, four = packed.shape
    assert (frags, lanes, four) == (4, 32, 4)
    for p in range(P):
        for tile in range(tiles):
            for chunk in range(chunks):
                for step in range(steps):
                    for n in range(frags):
                        for lane in range(lanes):
                            g, q = lane // 4, lane % 4
                            c, o = chunk * 4 + q, tile * 32 + n * 8 + g
                            for pair in range(2):
                                tap = 2 * step + pair
                                v_hi = float(packed[p, tile, chunk, step, n, lane, pair])
                                v_lo = float(packed[p, tile, chunk, step, n, lane, 2 + pair])
                                if c < C and o < O and tap < KT * NJ:
                                    hi[p, c, tap, o], lo[p, c, tap, o] = v_hi, v_lo
                                else:
                                    assert v_hi == 0 and v_lo == 0   # padding
    return hi.reshape(P, C, KT, NJ, O), lo.reshape(P, C, KT, NJ, O)


@pytest.mark.parametrize('C,O,k', [(5, 40, (3, 9)), (4, 32, (3, 3))])
def test_pack_weight_is_the_fragment_order(C, O, k):
    rng = np.random.default_rng(C + O)
    wc = torch.from_numpy(rng.standard_normal((2, C, *k, O)).astype(np.float32))
    packed = dck.pack_weight(wc)
    hi, lo = _unpack(packed, C, *k, O)
    want_hi, want_lo = dck.split_tf32(wc)
    assert torch.equal(hi, want_hi.double()) and torch.equal(lo, want_lo.double())


def _conv3(op, a, w):
    """3xTF32 emulation: a_lo·w_hi + a_hi·w_lo + a_hi·w_hi, summed in float64."""
    (a_hi, a_lo), (w_hi, w_lo) = dck.split_tf32(a), dck.split_tf32(w)
    a_hi, a_lo, w_hi, w_lo = (t.double() for t in (a_hi, a_lo, w_hi, w_lo))
    return op(a_lo, w_hi) + op(a_hi, w_lo) + op(a_hi, w_hi)


def _conv_fwd(a, w):
    return F.conv2d(a, w, None, STRIDE, PADDING, DILATION)


def test_tf32x3_forward_holds_the_f32_conv():
    x, w = _data(1)
    ref = F.conv2d(x.double(), w.double(), None, STRIDE, PADDING, DILATION)
    # the weights as the kernel sees them: packed, then read back
    hi, lo = _unpack(dck.pack_weight(w.permute(1, 2, 3, 0)[None]), 32, *KERNEL, 32)
    x_hi, x_lo = (t.double() for t in dck.split_tf32(x))

    def conv(a, wc):
        return F.conv2d(a, wc[0].permute(3, 0, 1, 2), None, STRIDE, PADDING, DILATION)
    got = conv(x_lo, hi) + conv(x_hi, lo) + conv(x_hi, hi)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.allclose(got, _conv3(_conv_fwd, x, w))
    # one TF32 pass alone is far off: the low parts carry the f32 accuracy
    one_pass = conv(x_hi, hi)
    assert float((one_pass - ref).abs().max()) > 1e-4 * float(ref.abs().max())


def test_tf32x3_input_grad_holds_the_f32_conv():
    x, w = _data(2)
    out_shape = F.conv2d(x, w, None, STRIDE, PADDING, DILATION).shape
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(out_shape).astype(np.float32))

    def conv_in(a, wt):
        return torch.nn.grad.conv2d_input(x.shape, wt, a, STRIDE, PADDING, DILATION)
    ref = conv_in(g.double(), w.double())
    # the per-phase dx weights as the kernel sees them, read back into w's layout
    sf, KT, KF = STRIDE[1], *KERNEL
    NJ = -(-KF // sf)
    hi, lo = _unpack(dck.pack_weight(dck.pack_dx_weight(w, sf)), 32, KT, NJ, 32)
    w_hi, w_lo = (torch.zeros(32, 32, KT, KF, dtype=torch.float64) for _ in range(2))
    for r in range(sf):
        for m in range(KT):
            for j in range(NJ):
                kf = r + sf * (NJ - 1 - j)
                if kf < KF:   # [r, co, m, j, ci] = w[co, ci, KT-1-m, kf]
                    w_hi[:, :, KT - 1 - m, kf] = hi[r, :, m, j, :]
                    w_lo[:, :, KT - 1 - m, kf] = lo[r, :, m, j, :]
    g_hi, g_lo = (t.double() for t in dck.split_tf32(g))
    got = conv_in(g_lo, w_hi) + conv_in(g_hi, w_lo) + conv_in(g_hi, w_hi)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.allclose(got, _conv3(conv_in, g, w))
