"""The port's training slice vs the JAX package on the CPU.

One test per module (balancer, schedule, Adam, RVQ training forward,
``forward_train``, dataset crops), the CLI on the CPU, and one whole GAN
step against ``build_train_step`` at the tiny widths of
tests/test_train_step.py. The same seeded weights and inputs go through
both; random choices the JAX
package makes from its keys (bandwidth, disc coin, k-means seeds, expiry
draws) are computed from the same keys with JAX and handed to the port.
Every JAX reference is jitted: eager JAX compiles each op on its own and is
far slower here.

Tolerances: integers (codes, crops) exact; floats to 1e-5 · max|ref| (f32,
different summation orders); gradients by relative L2 norm to 1e-4 (longer
chains of the same roundoff) over each model's parameters, and to 1e-3 for
each parameter alone (a leaf with a small gradient carries more relative
roundoff than the whole). Adam's first update is lr · g / (|g| + ε),
about ±lr, so updates are compared divided by lr: to 1e-3 where
|g| > 100 ε (there a gradient off by a few percent moves g / (|g| + ε) by
less), and for sign everywhere but |g| ≤ 10 ε, where roundoff may flip it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from encodec_pytorch_tpu.config import Config as JaxConfig
from encodec_pytorch_tpu.data.dataset import CustomAudioDataset as JaxDataset
from encodec_pytorch_tpu.data.dataset import DataLoader as JaxLoader
from encodec_pytorch_tpu.convert import msstftd_params_from_torch
from encodec_pytorch_tpu.models.model import EncodecModel as JaxModel
from encodec_pytorch_tpu.models.model import variables_from_torch_state_dict
from encodec_pytorch_tpu.models.msstftd import MultiScaleSTFTDiscriminator as JaxDisc
from encodec_pytorch_tpu.quantization import core_vq as jvq
from encodec_pytorch_tpu.train.balancer import Balancer as JaxBalancer
from encodec_pytorch_tpu.train.schedule import warmup_cosine_schedule as jax_schedule
from encodec_pytorch_tpu.train.step import TrainState, build_train_step
from encodec_pytorch_tpu_torch import config as tconfig
from encodec_pytorch_tpu_torch import convert, train_cli
from encodec_pytorch_tpu_torch.data import CustomAudioDataset, DataLoader
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.models.msstftd import MultiScaleSTFTDiscriminator
from encodec_pytorch_tpu_torch.quantization import core_vq as tvq
from encodec_pytorch_tpu_torch.train.balancer import Balancer
from encodec_pytorch_tpu_torch.train.schedule import warmup_cosine_schedule
from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step
from encodec_pytorch_tpu_torch.train.trainer import build_disc_from_config, build_model_from_config
from encodec_pytorch_tpu_torch.utils import write_wav
from test_torch_disc import close, rel_norm

torch.set_num_threads(1)

WEIGHTS = {'l_t': 0.1, 'l_f': 1, 'l_g': 3, 'l_feat': 3}


def test_balancer_matches_jax():
    rng = np.random.default_rng(0)
    calls = [{k: rng.standard_normal((3, 1, 50)).astype(np.float32) * s
              for k, s in zip(sorted(WEIGHTS), (1., 1e-3, 10., 0.1))} for _ in range(3)]
    jb, tb = JaxBalancer(WEIGHTS), Balancer(WEIGHTS)
    step = jax.jit(jb.__call__)
    state = jb.init_state()
    for i, grads in enumerate(calls):
        ref, state, _ = step({k: jnp.asarray(v) for k, v in grads.items()}, state)
        got, _ = tb({k: torch.from_numpy(v) for k, v in grads.items()})
        if i == 0:
            close(got.numpy(), ref)
    for k in WEIGHTS:
        close(tb.total[k].item(), state.total[k])
        close(tb.fix[k].item(), state.fix[k])
    close(got.numpy(), ref)


def test_schedule_matches_jax():
    for warmup in (0, 10):
        kw = dict(max_iter=100, eta_ratio=0.1, warmup_iter=warmup, warmup_ratio=1e-4)
        ref, got = jax.jit(jax_schedule(3e-4, **kw)), warmup_cosine_schedule(3e-4, **kw)
        for step in (0, warmup, 57, 100):
            np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)


def test_adam_matches_optax():
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)]
    lrs = (1e-3, 5e-4, 2e-4)
    opt = optax.scale_by_adam(b1=0.5, b2=0.9, eps=1e-8)

    @jax.jit
    def ref_fn(p):
        state = opt.init(p)
        for g, lr in zip(grads, lrs):
            upd, state = opt.update(g, state, p)
            p = p - lr * upd
        return p

    p = ref_fn(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    adam = make_optimizer([param])
    for g, lr in zip(grads, lrs):
        param.grad = torch.from_numpy(g)
        adam.param_groups[0]['lr'] = lr
        adam.step()
    close(param.detach().numpy(), p, rel=1e-6)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_draws(key, n_q_max: int, m: int, bins: int):
    def rows(k):
        if m >= bins:
            return jax.random.permutation(k, m)[:bins]
        return jax.random.randint(k, (bins,), 0, m)
    return [[rows(k) for k in jax.random.split(key_k)] for key_k in jax.random.split(key, n_q_max)]


def jax_stage_draws(key, n_q_max: int, m: int, bins: int):
    """The k-means seed and expiry rows the JAX ``rvq_forward`` draws from
    ``key`` for each stage."""
    return [{'init': torch.from_numpy(np.array(i)), 'expire': torch.from_numpy(np.array(e))}
            for i, e in _jax_draws(key, n_q_max, m, bins)]


# one compiled JAX reference for both cases (the state is an argument)
_jax_rvq = jax.jit(jvq.rvq_forward, static_argnames=('n_q', 'kmeans_iters'))


@pytest.mark.parametrize('fresh', [False, True], ids=['ema', 'kmeans_and_expiry'])
def test_rvq_forward_matches_jax(fresh):
    """``fresh=False``: inited codebooks with cluster size 10 (no init, no
    expiry); ``fresh=True``: k-means init and dead-code expiry, with the JAX
    draws handed in."""
    K, bins, D, B, T, n_q = 3, 64, 16, 2, 40, 2
    rng = np.random.default_rng(2 + fresh)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    embed = rng.standard_normal((K, bins, D)).astype(np.float32)
    state = jvq.CodebookState(
        inited=np.full(K, 0. if fresh else 1., np.float32),
        cluster_size=np.full((K, bins), 0. if fresh else 10., np.float32),
        embed=embed, embed_avg=(embed * 10).astype(np.float32))
    key = jax.random.PRNGKey(4)
    kw = dict(kmeans_iters=10)
    q_ref, codes_ref, pen_ref, new_ref = _jax_rvq(state, jnp.asarray(x), n_q=n_q, key=key,
                                                  **kw)
    states = [tvq.StageState(*(torch.from_numpy(np.array(a[k])).reshape(np.shape(a[k]) or (1,))
                               for a in state)) for k in range(K)]
    q, codes, pen, new = tvq.rvq_forward(states, torch.from_numpy(x), n_q,
                                         draws=jax_stage_draws(key, K, B * T, bins), **kw)
    np.testing.assert_array_equal(codes.numpy(), codes_ref)
    close(q.numpy(), q_ref)
    close(pen.item(), pen_ref)
    for k in range(K):
        for name, got in new[k]._asdict().items():
            close(got.numpy().reshape(-1), np.asarray(getattr(new_ref, name)[k]).reshape(-1))


TINY = dict(target_bandwidths=[1.5, 3.], sample_rate=24000, channels=1, causal=True,
            model_norm='weight_norm', audio_normalize=True, n_q=2, n_filters=4, ratios=(8,))
DISC = dict(filters=4, n_ffts=(256,), hop_lengths=(64,), win_lengths=(256,))


def test_dataset_crops_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    paths = []
    for i, n in enumerate((900, 1500, 700, 2000, 1200)):
        paths.append(str(tmp_path / f'{i}.wav'))
        write_wav(paths[-1], rng.uniform(-0.5, 0.5, (1, n)).astype(np.float32), 24000)
    (tmp_path / 'train.csv').write_text('\n'.join(paths) + '\n')
    data = {'datasets': {'train_csv_path': str(tmp_path / 'train.csv'), 'tensor_cut': 800,
                         'fixed_length': 0},
            'model': {'sample_rate': 24000, 'channels': 1}}
    ours = DataLoader(CustomAudioDataset(tconfig.Config(data), seed=3401), 2,
                      fixed_length=800, seed=3401)
    ref = JaxLoader(JaxDataset(JaxConfig(data), seed=3401), 2, fixed_length=800, seed=3401,
                    prefetch=0)
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


class _MonitoredBalancer(JaxBalancer):
    """The JAX balancer, also reporting the norm of the cotangent it builds
    (the step merges the balancer's metrics into its own)."""

    def __call__(self, grads, state):
        out, new, metrics = super().__call__(grads, state)
        return out, new, {**metrics, 'balanced_grad_norm': jnp.linalg.norm(out)}


class _CapturedModel(JaxModel):
    """The JAX model, handing its training forward's output to the host."""
    captured = {}

    def forward_train(self, variables, x, key, remat=False):
        out, loss_w, state = super().forward_train(variables, x, key, remat)
        jax.debug.callback(lambda o, l: self.captured.update(out=np.asarray(o),
                                                             loss_w=np.asarray(l)), out, loss_w)
        return out, loss_w, state


@pytest.fixture(scope='module')
def jax_step():
    """One jitted JAX step of ``build_train_step``, at tests/test_train_step.py's
    tiny widths with volume normalization on (as in the training config),
    one SEANet stage (ratio 8, so that tracing and compiling the JAX step
    stay within the test budget; every stage runs the same code), the
    discriminator on its plain path, and no LR warmup so that updates stand
    well above f32 roundoff; at PRNGKey(2) with the disc update allowed. The
    weights are the port's seeded init carried over by the JAX package's own
    converters; the codebooks start empty, so the step runs the k-means init
    and the expiry. Built once for the module's two tests."""
    jm = JaxModel._get_model(segment=None, **TINY)
    jm.__class__ = _CapturedModel
    jd = JaxDisc(fpack=0, **DISC)
    sched = jax_schedule(3e-4, max_iter=100, eta_ratio=0.1, warmup_iter=0, warmup_ratio=1e-4)
    jb = _MonitoredBalancer(WEIGHTS)
    step_fn = build_train_step(jm, jd, jb, sched, sched, disc_prob=1.0, sample_rate=24000)
    gen = torch.Generator().manual_seed(8)
    numpy_sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    variables = jax.device_get(variables_from_torch_state_dict(
        jm, numpy_sd(EncodecModel._get_model(generator=gen, **TINY))))
    params_d = jax.device_get(msstftd_params_from_torch(numpy_sd(
        MultiScaleSTFTDiscriminator(generator=gen, **DISC))))
    # ``optax.scale_by_adam``'s init, in numpy (eager JAX compiles each zeros_like)
    adam0 = lambda p: optax.ScaleByAdamState(np.zeros((), np.int32), *(
        jax.tree.map(np.zeros_like, p) for _ in range(2)))
    state = TrainState(variables['params'], params_d, variables['quantizer'],
                       adam0(variables['params']), adam0(params_d),
                       jax.device_get(jb.init_state()), np.zeros((), np.int32))
    batch = np.random.default_rng(8).standard_normal((2, 1, 1200)).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(2)
    args = (state, jnp.asarray(batch), key, jnp.asarray(True))
    new_state, metrics = jax.device_get(jax.jit(step_fn).lower(*args).compile(
        {'xla_backend_optimization_level': 0})(*args))
    # the step's random choices, from its keys
    @jax.jit
    def choices(key):
        rng_bw, rng_coin = jax.random.split(jax.random.fold_in(key, 0))
        k_bw, k_q = jax.random.split(rng_bw)
        return (jax.random.randint(k_bw, (), 0, 2), jax.random.uniform(rng_coin) < 1.0,
                jax.random.fold_in(k_q, 0))
    bw_index, coin, k_q = choices(key)
    n_q = int(jm.n_q_for_bandwidth_index()[int(bw_index)])
    draws = jax_stage_draws(k_q, TINY['n_q'], 2 * 1200 // 8, 1024)
    return dict(state=jax.device_get(state), new_state=new_state, metrics=metrics, batch=batch,
                n_q=n_q, coin=bool(coin), draws=draws, lr=float(sched(0)), **_CapturedModel.captured)


def _port_modules(state):
    sds = convert.train_state_from_jax(state, DISC['win_lengths'])
    model = EncodecModel._get_model(**TINY)
    model.load_state_dict(sds['model'], strict=True)
    disc = MultiScaleSTFTDiscriminator(**DISC)
    disc.load_state_dict(sds['disc'], strict=True)
    return model, disc, sds


def test_forward_train_matches_jax(jax_step):
    """The step's generator forward: output, commitment loss and codebook
    state, at the n_q the JAX step drew (k-means init and expiry with its
    draws)."""
    j = jax_step
    model, _, _ = _port_modules(j['state'])
    out, loss_w = model.forward_train(torch.from_numpy(j['batch']), j['n_q'], draws=j['draws'])
    close(out.detach().numpy(), j['out'])
    close(loss_w.item(), j['loss_w'])
    after = convert.train_state_from_jax(j['new_state'], DISC['win_lengths'])['model']
    for k, v in model.state_dict().items():
        if k.startswith('quantizer.'):
            close(v.numpy(), after[k].numpy())


def test_whole_train_step_matches_jax(jax_step):
    j = jax_step
    model, disc, sds = _port_modules(j['state'])
    before = {'model': {k: v.clone() for k, v in model.state_dict().items()},
              'disc': {k: v.clone() for k, v in disc.state_dict().items()}}
    balancer = Balancer(WEIGHTS)
    metrics = train_step(model, disc, balancer, make_optimizer(model.parameters()),
                         make_optimizer(disc.parameters()), torch.from_numpy(j['batch']),
                         n_q=j['n_q'], train_disc=j['coin'], lr_g=j['lr'], lr_d=j['lr'],
                         sample_rate=24000, draws=j['draws'])

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

    # gradients (JAX: Adam's first moment / (1 - b1)) and updates over lr
    grads = convert.train_state_from_jax(new._replace(
        params_g=jax.tree.map(lambda m: m / 0.5, new.opt_g.mu),
        params_d=jax.tree.map(lambda m: m / 0.5, new.opt_d.mu)), DISC['win_lengths'])
    for key, module in (('model', model), ('disc', disc)):
        named = list(module.named_parameters())
        buffers = dict(module.named_buffers())
        # every JAX leaf is a parameter here; the rest of the state dict
        # (codebooks, the LSTM's bias_hh) is buffers, and those equal JAX's
        assert {n for n, _ in named} == set(grads[key]) - set(buffers)
        for name, b in buffers.items():
            if not name.startswith('quantizer.'):
                np.testing.assert_array_equal(b.numpy(), after[key][name].numpy(), err_msg=name)
        rel_norm(np.concatenate([p.grad.numpy().ravel() for _, p in named]),
                 np.concatenate([grads[key][n].numpy().ravel() for n, _ in named]))
        for name, p in named:
            g_ref = grads[key][name].numpy()
            # a leaf whose gradient is small next to the rest carries more
            # relative roundoff than the whole
            rel_norm(p.grad.numpy(), g_ref, rel=1e-3)
            upd = (p.detach().numpy() - before[key][name].numpy()) / j['lr']
            upd_ref = (after[key][name].numpy() - sds[key][name].numpy()) / j['lr']
            clear = np.abs(g_ref) > 1e-6          # 100 ε: the update is g / |g| to 1 %
            np.testing.assert_allclose(upd[clear], upd_ref[clear], atol=1e-3, err_msg=name)
            flip = np.sign(upd) != np.sign(upd_ref)
            assert not (flip & (np.abs(g_ref) > 1e-7)).any(), name   # flips only at |g| ≲ 10 ε


def test_train_cli_cpu(tmp_path, monkeypatch):
    """The port's CLI: one epoch of two steps on the CPU at a tiny config (in
    the default set's bf16), finite losses, both models trained; without a
    card, the default device is refused, a config the launcher contradicts
    (data parallelism over two processes, started as one) raises, and so does
    a resume without a checkpoint path."""
    rng = np.random.default_rng(9)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f'{i}.wav'))
        write_wav(paths[-1], rng.uniform(-0.3, 0.3, (1, 2400)).astype(np.float32), 24000)
    (tmp_path / 'train.csv').write_text('\n'.join(paths) + '\n')
    tiny = [f'datasets.train_csv_path={tmp_path / "train.csv"}',
            f'datasets.test_csv_path={tmp_path / "train.csv"}',
            f'checkpoint.save_folder={tmp_path / "ckpt"}/', 'datasets.tensor_cut=1200',
            'datasets.batch_size=2', 'common.max_epoch=1', 'model.n_filters=4', 'model.n_q=2',
            'model.filters=4', 'model.disc_n_ffts=[256]', 'model.disc_hop_lengths=[64]',
            'model.disc_win_lengths=[256]', 'lr_scheduler.warmup_epoch=0']
    trainer = train_cli.main(['--device', 'cpu', *tiny])
    summary = trainer.history[-1]
    assert summary['steps'] == 2 and summary['disc_updated'] == 1.0
    assert all(np.isfinite(v) for k, v in summary.items() if k != 'step_ms')
    init = torch.Generator().manual_seed(3401)
    config = tconfig.load_config(tiny)
    for built, trained in ((build_model_from_config(config, 'cpu', init), trainer.model),
                           (build_disc_from_config(config, 'cpu', init), trainer.disc)):
        assert any(not torch.equal(a, b) for a, b in zip(built.parameters(),
                                                         trained.parameters()))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit):
        train_cli.main(tiny)
    with pytest.raises(ValueError, match='world_size=2, but the launcher started 1'):
        train_cli.main(['--device', 'cpu', *tiny, 'distributed.data_parallel=true',
                        'distributed.world_size=2'])
    with pytest.raises(ValueError, match='checkpoint_path'):
        train_cli.main(['--device', 'cpu', *tiny, 'checkpoint.resume=True'])
