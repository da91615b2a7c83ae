"""The port's 48 kHz stereo training step vs the JAX package on the CPU.

One whole GAN step of ``build_train_step`` at a shrunk ``config_48k_stereo``
(2 channels, non-causal, ``time_group_norm``, volume-normalized segments of
0.04 s, so a 4800-sample clip is three segments overlap-added, the last of
1000 samples; balancer weights l_g = l_feat = 4; one SEANet stage and
``n_filters=4`` so that the JAX step compiles within the test budget). The
discriminator keeps the 48 kHz config's 32 filters at one small STFT scale,
with ``tpu.disc_im2col`` and ``tpu.disc_pallas_v2`` on, so its
``conv_1``..``conv_3`` run kernel K5's route (the im2col GEMM forward, K4's
dx, cuDNN's dW; all plain here) and ``conv_4`` K4's. The JAX step's random
choices (bandwidth, disc coin, each segment's k-means and expiry draws) are
computed from its keys and handed to the port. Bars: those of
tests/test_torch_train.py (losses and metrics to 1e-5 · |ref|, the balanced
gradient's norm to 1e-4; gradients by relative L2 norm to 1e-4 over each
model and 1e-3 per parameter; updates over lr to 1e-3 where |g| > 100 ε).

The JAX reference step is traced with flax's two-pass GroupNorm variance
(``use_fast_variance=False``), the same function as its default
E[x²] − E[x]². At f32 the default loses accuracy to cancellation: measured
against a float64 run of the port's step, the JAX generator gradient was
3.3e-4 off by relative norm with it and 9e-7 without it, the port's f32
gradient 9e-7. Nothing in the JAX package changes; the patch lasts while the
reference compiles.

Also: stereo crops equal to the JAX dataset's, and ``train_cli --config
config_48k_stereo --device cpu``.
"""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from encodec_pytorch_tpu.config import Config as JaxConfig
from encodec_pytorch_tpu.convert import msstftd_params_from_torch
from encodec_pytorch_tpu.data.dataset import CustomAudioDataset as JaxDataset
from encodec_pytorch_tpu.data.dataset import DataLoader as JaxLoader
from encodec_pytorch_tpu.models.model import variables_from_torch_state_dict
from encodec_pytorch_tpu.models.msstftd import MultiScaleSTFTDiscriminator as JaxDisc
from encodec_pytorch_tpu.train.schedule import warmup_cosine_schedule as jax_schedule
from encodec_pytorch_tpu.train.step import TrainState, build_train_step
from encodec_pytorch_tpu_torch import config as tconfig
from encodec_pytorch_tpu_torch import convert, train_cli
from encodec_pytorch_tpu_torch.data import CustomAudioDataset, DataLoader
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.models.msstftd import MultiScaleSTFTDiscriminator
from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
from encodec_pytorch_tpu_torch.train.balancer import Balancer
from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step
from encodec_pytorch_tpu_torch.train.trainer import build_disc_from_config, build_model_from_config
from encodec_pytorch_tpu_torch.utils import write_wav
from test_torch_disc import close, rel_norm
from test_torch_train import _CapturedModel, _MonitoredBalancer, jax_stage_draws

torch.set_num_threads(1)

SR = 48000
WEIGHTS = {'l_t': 0.1, 'l_f': 1, 'l_g': 4, 'l_feat': 4}
# 60 kbps a codebook at 6000 frames a second: n_q 1 or 2
TINY = dict(target_bandwidths=[60., 120.], sample_rate=SR, channels=2, causal=False,
            model_norm='time_group_norm', audio_normalize=True, segment=0.04, n_q=2,
            n_filters=4, ratios=(8,))
DISC = dict(filters=32, in_channels=2, out_channels=2, n_ffts=(128,), hop_lengths=(64,),
            win_lengths=(128,))
B, T = 2, 4800


@pytest.fixture(scope='module')
def jax_step():
    """One jitted JAX step at PRNGKey(5), the disc update allowed and no LR
    warmup; weights are the port's seeded init carried over by the JAX
    package's converters; the codebooks start empty (k-means init on the first
    segment, then EMA)."""
    jm = _CapturedModel._get_model(**TINY)
    jm.__class__ = _CapturedModel
    jd = JaxDisc(fpack=0, **DISC)
    sched = jax_schedule(3e-4, max_iter=100, eta_ratio=0.1, warmup_iter=0, warmup_ratio=1e-4)
    jb = _MonitoredBalancer(WEIGHTS)
    step_fn = build_train_step(jm, jd, jb, sched, sched, disc_prob=1.0, sample_rate=SR)
    gen = torch.Generator().manual_seed(11)
    numpy_sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    variables = jax.device_get(variables_from_torch_state_dict(
        jm, numpy_sd(EncodecModel._get_model(generator=gen, **TINY))))
    params_d = jax.device_get(msstftd_params_from_torch(numpy_sd(
        MultiScaleSTFTDiscriminator(generator=gen, **DISC))))
    adam0 = lambda p: optax.ScaleByAdamState(np.zeros((), np.int32), *(
        jax.tree.map(np.zeros_like, p) for _ in range(2)))
    state = TrainState(variables['params'], params_d, variables['quantizer'],
                       adam0(variables['params']), adam0(params_d),
                       jax.device_get(jb.init_state()), np.zeros((), np.int32))
    rng = np.random.default_rng(12)
    mono = rng.standard_normal((B, 1, T))
    batch = (0.1 * np.concatenate([mono, 0.5 * mono + 0.5 * rng.standard_normal(mono.shape)],
                                  axis=1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    args = (state, jnp.asarray(batch), key, jnp.asarray(True))
    group_norm = flax.linen.GroupNorm
    flax.linen.GroupNorm = functools.partial(group_norm, use_fast_variance=False)
    try:
        compiled = jax.jit(step_fn).lower(*args).compile({'xla_backend_optimization_level': 0})
    finally:
        flax.linen.GroupNorm = group_norm
    new_state, metrics = jax.device_get(compiled(*args))

    @jax.jit
    def choices(key):
        rng_bw, rng_coin = jax.random.split(jax.random.fold_in(key, 0))
        k_bw, k_q = jax.random.split(rng_bw)
        return jax.random.randint(k_bw, (), 0, 2), jax.random.uniform(rng_coin) < 1.0, k_q
    bw_index, coin, k_q = choices(key)
    n_q = int(jm.n_q_for_bandwidth_index()[int(bw_index)])
    L, stride = jm.segment_length, jm.segment_stride
    draws = [jax_stage_draws(jax.random.fold_in(k_q, i), TINY['n_q'],
                             B * -(-min(L, T - o) // 8), 1024)
             for i, o in enumerate(range(0, T, stride))]
    return dict(state=jax.device_get(state), new_state=new_state, metrics=metrics, batch=batch,
                n_q=n_q, coin=bool(coin), draws=draws, lr=float(sched(0)),
                **_CapturedModel.captured)


def _port_modules(state):
    sds = convert.train_state_from_jax(state, DISC['win_lengths'])
    model = EncodecModel._get_model(**TINY)
    model.load_state_dict(sds['model'], strict=True)
    disc = MultiScaleSTFTDiscriminator(disc_kernel=True, disc_im2col=True, **DISC)
    disc.load_state_dict(sds['disc'], strict=True)
    return model, disc, sds


def test_whole_48k_train_step_matches_jax(jax_step, monkeypatch):
    j = jax_step
    assert len(j['draws']) == 3
    model, disc, sds = _port_modules(j['state'])
    assert [c.uses_im2col for c in disc.discriminators[0].convs] == [False, True, True, True,
                                                                     False]
    k5_calls = []
    real = k5.disc_im2col_forward
    monkeypatch.setattr(k5, 'disc_im2col_forward',
                        lambda *a, **kw: k5_calls.append(1) or real(*a, **kw))
    before = {'model': {k: v.clone() for k, v in model.state_dict().items()},
              'disc': {k: v.clone() for k, v in disc.state_dict().items()}}
    balancer = Balancer(WEIGHTS)
    metrics = train_step(model, disc, balancer, make_optimizer(model.parameters()),
                         make_optimizer(disc.parameters()), torch.from_numpy(j['batch']),
                         n_q=j['n_q'], train_disc=j['coin'], lr_g=j['lr'], lr_d=j['lr'],
                         sample_rate=SR, draws=j['draws'])
    assert len(k5_calls) == 9          # real, fake and the disc update: 3 convs each

    ref = j['metrics']
    for k in ('l_t', 'l_f', 'l_g', 'l_feat', 'loss_g', 'loss_w', 'loss_disc',
              'balanced_grad_norm', 'codebook_entropy', 'codebook_dead_frac'):
        close(metrics[k].item(), ref[k], rel=1e-4 if k == 'balanced_grad_norm' else 1e-5)
    new = j['new_state']
    for k in WEIGHTS:
        close(balancer.total[k].item(), new.balancer.total[k])
        close(balancer.fix[k].item(), new.balancer.fix[k])
    after = convert.train_state_from_jax(new, DISC['win_lengths'])
    for k, v in model.state_dict().items():
        if k.startswith('quantizer.'):
            close(v.numpy(), after['model'][k].numpy())

    grads = convert.train_state_from_jax(new._replace(
        params_g=jax.tree.map(lambda m: m / 0.5, new.opt_g.mu),
        params_d=jax.tree.map(lambda m: m / 0.5, new.opt_d.mu)), DISC['win_lengths'])
    for key, module in (('model', model), ('disc', disc)):
        named = list(module.named_parameters())
        buffers = dict(module.named_buffers())
        assert {n for n, _ in named} == set(grads[key]) - set(buffers)
        assert key == 'disc' or any(n.endswith('.norm.weight') for n, _ in named)
        for name, b in buffers.items():
            if not name.startswith('quantizer.'):
                np.testing.assert_array_equal(b.numpy(), after[key][name].numpy(), err_msg=name)
        rel_norm(np.concatenate([p.grad.numpy().ravel() for _, p in named]),
                 np.concatenate([grads[key][n].numpy().ravel() for n, _ in named]))
        for name, p in named:
            g_ref = grads[key][name].numpy()
            rel_norm(p.grad.numpy(), g_ref, rel=1e-3)
            upd = (p.detach().numpy() - before[key][name].numpy()) / j['lr']
            upd_ref = (after[key][name].numpy() - sds[key][name].numpy()) / j['lr']
            clear = np.abs(g_ref) > 1e-6
            np.testing.assert_allclose(upd[clear], upd_ref[clear], atol=1e-3, err_msg=name)
            flip = np.sign(upd) != np.sign(upd_ref)
            assert not (flip & (np.abs(g_ref) > 1e-7)).any(), name


def test_forward_train_segments_match_jax(jax_step):
    """The generator forward alone: three normalized segments, overlap-added."""
    j = jax_step
    model, _, _ = _port_modules(j['state'])
    out, loss_w = model.forward_train(torch.from_numpy(j['batch']), j['n_q'], draws=j['draws'])
    close(out.detach().numpy(), j['out'])
    close(loss_w.item(), j['loss_w'])


def _stereo_csv(tmp_path, lengths, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(lengths):
        paths.append(str(tmp_path / f'{i}.wav'))
        write_wav(paths[-1], rng.uniform(-0.3, 0.3, (2, n)).astype(np.float32), SR)
    (tmp_path / 'train.csv').write_text('\n'.join(paths) + '\n')
    return tmp_path / 'train.csv'


def test_stereo_dataset_crops_equal_jax(tmp_path):
    csv = _stereo_csv(tmp_path, (5000, 7000, 4000, 9000, 6000), 13)
    data = {'datasets': {'train_csv_path': str(csv), 'tensor_cut': 4800, 'fixed_length': 0},
            'model': {'sample_rate': SR, 'channels': 2}}
    ours = DataLoader(CustomAudioDataset(tconfig.Config(data), seed=3401), 2,
                      fixed_length=4800, seed=3401)
    ref = JaxLoader(JaxDataset(JaxConfig(data), seed=3401), 2, fixed_length=4800, seed=3401,
                    prefetch=0)
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.shape == (2, 2, 4800)
            np.testing.assert_array_equal(a, b)


def test_train_cli_48k_cpu(tmp_path):
    """``--config config_48k_stereo`` on the CPU at a tiny width: the 48 kHz
    defaults reach the model and the discriminator (K5's route on), and one
    epoch of two steps trains both."""
    csv = _stereo_csv(tmp_path, (6000,) * 4, 14)
    tiny = [f'datasets.train_csv_path={csv}', f'datasets.test_csv_path={csv}',
            f'checkpoint.save_folder={tmp_path / "ckpt"}/', 'datasets.tensor_cut=4800',
            'datasets.batch_size=2', 'common.max_epoch=1', 'model.n_filters=4', 'model.n_q=2',
            'model.ratios=[8]', 'model.target_bandwidths=[60.,120.]', 'model.segment=0.04',
            'model.disc_n_ffts=[128]', 'model.disc_hop_lengths=[64]',
            'model.disc_win_lengths=[128]', 'lr_scheduler.warmup_epoch=0']
    trainer = train_cli.main(['--device', 'cpu', '--config', 'config_48k_stereo', *tiny])
    model, disc = trainer.model, trainer.disc
    assert (model.sample_rate, model.channels, model.normalize, model.segment_length) == (
        SR, 2, True, 1920)
    assert not model.encoder.causal and any(n.endswith('norm.weight')
                                            for n, _ in model.named_parameters())
    assert [c.uses_im2col for c in disc.discriminators[0].convs] == [False, True, True, True,
                                                                     False]
    assert trainer.balancer.weights['l_g'] == 4
    summary = trainer.history[-1]
    assert summary['steps'] == 2 and summary['disc_updated'] == 1.0
    assert all(np.isfinite(v) for k, v in summary.items() if k != 'step_ms')
    init = torch.Generator().manual_seed(3401)
    config = tconfig.load_config(tiny, 'config_48k_stereo')
    for built, trained in ((build_model_from_config(config, 'cpu', init), model),
                           (build_disc_from_config(config, 'cpu', init), disc)):
        assert any(not torch.equal(a, b) for a, b in zip(built.parameters(),
                                                         trained.parameters()))
    with pytest.raises(ValueError, match='world_size=4, but the launcher started 1'):
        train_cli.main(['--device', 'cpu', '--config', 'config_48k_stereo', *tiny,
                        'distributed.world_size=4'])
