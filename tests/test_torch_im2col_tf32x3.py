"""The 3xTF32 route of kernel K5 (``csrc/disc_im2col.cu``), on the CPU.

K5 runs the discriminator's F-stride-2 convs on the tensor cores: each f32
operand is split into two TF32 parts and each term is the sum of three TF32
products. These tests hold the parts of that design that run without a card:

- the weight pack (``pack_weight``, the B images of the kernel's ``wgmma``
  k-steps), read back index by index through the layout its docstring
  states;
- an emulation of the kernel's route at a reduced conv_3 shape (B 2, 32
  channels, 3×9 taps at F-stride 2, T dilation 4, a ragged F and a T that is
  not a multiple of the tile): the input window staged as the kernel stages
  it, each thread's A fragment gathered at the kernel's offsets, the packed B
  images, the output rows mapped back as the kernel stores them, operands
  split by ``split_tf32`` and the three products summed in float64, against
  the float64 ``F.conv2d``: within 1e-5 of max|ref|.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5

# csrc/disc_im2col.cu: a block's output rows (2 warpgroups of 8) and columns
# (4 tiles of 8), and the staged window's row layout (71 columns, even ones
# first, then odd, in rows of 72 words)
ROWS, COLS, TILES, WARPGROUPS = 16, 32, 4, 2
HALF = 36
RS = 2 * HALF
KT, KF = k5.TAPS


def chan_stride(R):
    cs = R * RS
    return cs + (40 - cs % 32) % 32


def col_slot(j):
    return j // 2 + (j % 2) * HALF


def b_offset(co, k):
    """Where element ``(co, k)`` of a k-step sits in its B image."""
    return (co // 8) * 64 + (k // 4) * 32 + (co % 8) * 4 + k % 4


def _weights(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((32, 32, KT, KF))
                             / np.sqrt(32 * KT * KF)).astype(np.float32))


def test_pack_weight_is_the_b_image_layout():
    w = _weights(0)
    packed = k5.pack_weight(w)
    assert packed.shape == (32 // k5.CHUNK, k5.STEPS, 2, k5.B_IMAGE)
    want_hi, want_lo = dck.split_tf32(w)
    seen = torch.zeros(packed.shape, dtype=torch.bool)
    for chunk in range(32 // k5.CHUNK):
        for step in range(k5.STEPS):
            for k in range(8):
                tap = 2 * step + k // 4
                ci = k5.CHUNK * chunk + k % 4
                for co in range(32):
                    e = b_offset(co, k)
                    hi, lo = packed[chunk, step, 0, e], packed[chunk, step, 1, e]
                    seen[chunk, step, :, e] = True
                    if tap < KT * KF:
                        mt, mf = divmod(tap, KF)
                        assert hi == want_hi[co, ci, mt, mf] and lo == want_lo[co, ci, mt, mf]
                    else:
                        assert hi == 0 and lo == 0     # the 28th tap
    assert bool(seen.all())


def _stage_window(x, b, chunk, row0, col0, R):
    """The chunk's window as the kernel stages it: 4 channels x R rows x 71
    columns, even columns first, zero outside ``x``, in one flat buffer."""
    _, _, T, F_ = x.shape
    CS = chan_stride(R)
    c, r, j = torch.meshgrid(torch.arange(k5.CHUNK), torch.arange(R),
                             torch.arange(2 * (COLS - 1) + KF), indexing='ij')
    row, col = row0 + r, col0 + j
    ok = (row >= 0) & (row < T) & (col >= 0) & (col < F_)
    vals = x[b, k5.CHUNK * chunk + c, row.clamp(0, T - 1), col.clamp(0, F_ - 1)] * ok
    buf = torch.zeros(k5.CHUNK * CS, dtype=torch.float32)
    buf[c * CS + r * RS + j // 2 + (j % 2) * HALF] = vals
    return buf


def _emulate(x, w, bias, dt, pt, pf):
    """K5's arithmetic on the CPU, block by block, with the kernel's offsets;
    the three TF32 products summed in float64."""
    B, _, T, F_ = x.shape
    To, Fo = dck.out_size(T, F_, KT, KF, 2, dt, pt, pf)
    packed = k5.pack_weight(w).double()
    # the B images as [chunk, step, part, k, co]
    idx = torch.tensor([[b_offset(co, k) for co in range(32)] for k in range(8)])
    bmat = packed[..., idx]
    R = ROWS + (KT - 1) * dt
    CS = chan_stride(R)
    # a thread's A rows (warpgroup, warp, g, q) -> word of the window buffer
    wg, wl, g, q = torch.meshgrid(torch.arange(WARPGROUPS), torch.arange(4), torch.arange(8),
                                  torch.arange(4), indexing='ij')
    abase = q * CS + (8 * wg + 2 * wl) * RS + g
    y = torch.zeros(B, 32, To, Fo, dtype=torch.float64)
    for b in range(B):
        for t0 in range(0, To, ROWS):
            for f0 in range(0, Fo, COLS):
                tiles = min(TILES, -(-(Fo - f0) // 8))
                # [warpgroup, tile, 64 rows, 32 channels]
                acc = torch.zeros(WARPGROUPS, TILES, 64, 32, dtype=torch.float64)
                for chunk in range(32 // k5.CHUNK):
                    buf = _stage_window(x, b, chunk, t0 - pt, 2 * f0 - pf, R)
                    for s in range(k5.STEPS):
                        offs = []
                        for tap in (2 * s, 2 * s + 1):
                            mt, mf = divmod(tap, KF)
                            offs.append(mt * dt * RS + col_slot(mf) if tap < KT * KF else None)
                        for j in range(tiles):
                            # registers a0..a3: (row g, k q), (g+8, q), (g, q+4), (g+8, q+4)
                            v = torch.zeros(WARPGROUPS, 4, 8, 4, 4, dtype=torch.float32)
                            for i, off in enumerate((offs[0], offs[0], offs[1], offs[1])):
                                if off is not None:
                                    v[..., i] = buf[abase + 8 * j + off + (i % 2) * RS]
                            hi, lo = (t.double() for t in dck.split_tf32(v))
                            a = torch.zeros(2, WARPGROUPS, 4, 2, 8, 8, dtype=torch.float64)
                            for i in range(4):   # [part, wg, warp, row half, g, k]
                                for part, val in enumerate((hi, lo)):
                                    a[part, :, :, i % 2, :, 4 * (i // 2):4 * (i // 2) + 4] = (
                                        val[..., i])
                            a = a.reshape(2, WARPGROUPS, 64, 8)
                            b_hi, b_lo = bmat[chunk, s, 0], bmat[chunk, s, 1]
                            acc[:, j] += a[1] @ b_hi + a[0] @ b_lo + a[0] @ b_hi
                # rows 16 w + 8 h + g of tile j: time t0 + 8 wg + 2 w + h, column f0 + 8 j + g
                out = acc.reshape(WARPGROUPS, TILES, 4, 2, 8, 32)
                for wgi in range(WARPGROUPS):
                    for j in range(tiles):
                        for wli in range(4):
                            for h in range(2):
                                t = t0 + 8 * wgi + 2 * wli + h
                                cols = slice(f0 + 8 * j, min(f0 + 8 * j + 8, Fo))
                                n = cols.stop - cols.start
                                if t < To and n > 0:
                                    y[b, :, t, cols] = out[wgi, j, wli, h, :n].T
    return y + bias.double().reshape(1, -1, 1, 1)


@pytest.mark.parametrize('T,F_,dt', [(13, 45, 4), (20, 81, 1)])
def test_tf32x3_route_holds_the_f32_conv(T, F_, dt):
    """conv_3 of a scale cut to B 2 (To 13, not a multiple of 16; Fo 23, a
    ragged 8-column tile), and a conv_1 of two blocks along T and two along F
    (To 20, Fo 41: the second F block holds one full tile and one column)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 32, T, F_)).astype(np.float32))
    w = _weights(2)
    bias = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    pt, pf = dt, (KF - 1) // 2
    ref = F.conv2d(x.double(), w.double(), bias.double(), (1, 2), (pt, pf), (dt, 1))
    got = _emulate(x, w, bias, dt, pt, pf)
    assert got.shape == ref.shape
    top = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * top
    # one TF32 pass alone is far off: the low parts carry the f32 accuracy
    one_pass = F.conv2d(dck.split_tf32(x)[0].double(), dck.split_tf32(w)[0].double(),
                        bias.double(), (1, 2), (pt, pf), (dt, 1))
    assert float((one_pass - ref).abs().max()) > 1e-4 * top
    # the kernel's plain version agrees too
    plain = k5.disc_im2col_forward_plain(x, w, bias, (dt, 1), (pt, pf))
    assert float((plain.double() - ref).abs().max()) <= 1e-5 * top
