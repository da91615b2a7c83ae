"""Kernel K5's plain version and its trainable route vs the JAX package on the
CPU.

- :func:`disc_im2col_forward_plain` (the im2col GEMM in torch) against the
  TPU kernel ``conv2d_im2col`` run in interpret mode, at the 4 shapes of
  tests/test_pallas_conv2d.py, to its bar (atol and rtol 1e-4).
- The trainable conv (``disc_im2col``: K5 forward, K4's dx and cuDNN's dW,
  all on their plain versions here) against ``F.conv2d``'s autograd at the
  discriminator's three T dilations: outputs and the three gradients within
  1e-5 · max|ref| (f32 sums in another order).
- Routing: with ``disc_im2col`` on, the forward of ``conv_1``..``conv_3`` of a
  32-filter discriminator takes K5 and ``conv_4`` keeps K4; off, nothing
  changes. A tensor that is neither on the CPU nor on the card is refused
  rather than sent to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from encodec_pytorch_tpu.ops.pallas_conv2d import conv2d_im2col
from encodec_pytorch_tpu_torch.models.msstftd import MultiScaleSTFTDiscriminator
from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
from test_torch_disc import close

torch.set_num_threads(1)


@pytest.mark.parametrize('B,T,F_,C,KT,KF,dt', [(2, 13, 33, 4, 3, 9, 1),
                                               (1, 20, 65, 8, 3, 9, 2),
                                               (2, 11, 33, 4, 3, 9, 4),
                                               (1, 12, 17, 4, 3, 3, 1)])
def test_plain_matches_tpu_kernel_interpret(B, T, F_, C, KT, KF, dt):
    rng = np.random.RandomState(0)
    pt, pf = ((KT - 1) * dt) // 2, (KF - 1) // 2
    x = rng.randn(B, T, F_, C).astype(np.float32)                # NHWC, as the TPU kernel
    w = (rng.randn(KT, KF, C, C) * 0.1).astype(np.float32)       # HWIO
    ref = np.asarray(conv2d_im2col(jnp.asarray(x), jnp.asarray(w), (pt, pf), (dt, 1),
                                   interpret=True))
    got = k5.disc_im2col_forward_plain(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                       torch.from_numpy(w.transpose(3, 2, 0, 1)), None,
                                       (dt, 1), (pt, pf)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('dt', [1, 2, 4])
def test_autograd_route_matches_conv2d(dt):
    rng = np.random.default_rng(dt)
    x = rng.standard_normal((2, 32, 11, 37)).astype(np.float32)
    w = (rng.standard_normal((32, 32, 3, 9)) * 0.05).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    geo = dict(dilation=(dt, 1), padding=(dt, 4))
    assert k5.eligible(32, 32, (3, 9), (1, 2), **geo)
    ours = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    ref = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = k5.disc_im2col(*ours, **geo)
    y_ref = F.conv2d(*ref, stride=(1, 2), **geo)
    close(y.detach().numpy(), y_ref.detach().numpy())
    g = torch.from_numpy(rng.standard_normal(y_ref.shape).astype(np.float32))
    y.backward(g)
    y_ref.backward(g)
    for a, r in zip(ours, ref):
        close(a.grad.numpy(), r.grad.numpy())


def test_eligible_and_weight_packing():
    assert not k5.eligible(32, 32, (3, 3), (1, 1), (1, 1), (1, 1))     # conv_4
    assert not k5.eligible(4, 32, (3, 9), (1, 1), (1, 1), (1, 4))      # conv_0
    assert not k5.eligible(32, 32, (3, 9), (1, 2), (3, 1), (3, 4))     # T dilation 3
    assert not k5.eligible(16, 16, (3, 9), (1, 2), (1, 1), (1, 4))
    w = torch.randn(32, 32, 3, 9, generator=torch.Generator().manual_seed(0))
    wk = k5.pack_weight(w)
    c = k5.CHUNK
    assert wk.shape == (32 // c, 14, 2, 256)
    # chunk 2, k-step 5 (taps 10 and 11): k 7 is channel 2c + 3 at tap 11 (mt 1,
    # mf 2); output channel 13 sits at (13 // 8)·64 + 32 + (13 % 8)·4 + 3
    hi, lo = dck.split_tf32(w[13, 2 * c + 3, 1, 2])
    assert wk[2, 5, 0, 64 + 32 + 20 + 3] == hi and wk[2, 5, 1, 64 + 32 + 20 + 3] == lo
    assert abs(float(hi + lo - w[13, 2 * c + 3, 1, 2])) <= 2 ** -22 * abs(float(hi))


@pytest.mark.parametrize('disc_im2col', [False, True])
def test_discriminator_routes_f_stride_2_convs_to_k5(disc_im2col, monkeypatch):
    """With the switch on, each scale's conv_1..conv_3 forward goes through
    K5's wrapper (3 calls a scale) and conv_4 through K4's; the logits equal
    the switch-off run's to 1e-5 · max|ref|."""
    kw = dict(filters=32, in_channels=2, out_channels=2, n_ffts=(128,), hop_lengths=(32,),
              win_lengths=(128,), disc_kernel=True)
    disc = MultiScaleSTFTDiscriminator(disc_im2col=disc_im2col,
                                       generator=torch.Generator().manual_seed(1), **kw)
    convs = disc.discriminators[0].convs
    assert [c.uses_im2col for c in convs] == [False] + [disc_im2col] * 3 + [False]
    assert [c.uses_kernel for c in convs] == [False] + [not disc_im2col] * 3 + [True]
    counts = {'k5': 0, 'k4': 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    monkeypatch.setattr(k5, 'disc_im2col_forward', counted('k5', k5.disc_im2col_forward))
    monkeypatch.setattr(dck, 'disc_conv', counted('k4', dck.disc_conv))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 2, 1200))
                         .astype(np.float32) * 0.1)
    logits, fmaps = disc(x)
    assert counts == ({'k5': 3, 'k4': 1} if disc_im2col else {'k5': 0, 'k4': 4})
    assert logits[0].shape[1] == 2 and len(fmaps[0]) == 5
    other = MultiScaleSTFTDiscriminator(disc_im2col=not disc_im2col,
                                        generator=torch.Generator().manual_seed(1), **kw)
    with torch.no_grad():
        close(logits[0].numpy(), other(x)[0][0].numpy())


def test_unsupported_device_is_refused():
    x = torch.empty(1, 32, 8, 20, device='meta')
    w = torch.empty(32, 32, 3, 9, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        k5.disc_im2col_forward(x, w, None, (1, 1), (1, 4))
