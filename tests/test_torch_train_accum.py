"""Gradient accumulation and the non-finite step guard of the port's training
step, on the CPU, against the JAX package's ``build_train_step``.

- Accumulation over 2 microbatches of a duplicated batch equals the
  full-batch step (the JAX package's own check, tests/test_train_step.py:248,
  on the port, with its models and its learning rate, step 0 of a warmup;
  the quantizer frozen at a bit-exact EMA fixed point): losses within 2e-4
  relative, the discriminator's gradients within 2e-4 by relative norm, the
  parameters within 2e-4 relative + 1e-6.
- Accumulation over 4 microbatches of a batch of 8 against the JAX
  accumulated step from the same state and draws (f32): losses within 1e-5
  of their value (measured: at most 8.2e-7), the balancer's EMA of gradient
  norms within the gradients' 1e-4 (measured: 1.2e-5), gradients within
  1e-4 by relative norm (measured: 1.8e-5 generator, 3.3e-6
  discriminator), the codebook buffers within 1e-5 of max (measured:
  3.8e-7).
- The guard: a NaN batch leaves the whole state bit-equal (parameters,
  Adam's moments and step counts, codebooks, the balancer's EMA) with
  ``skipped_nonfinite`` 1; a clean batch then trains with 0, bit-equal to the
  same step unguarded.
- The trainer's config keys reach the step; a `datasets.dataset` other than
  `csv` and `multi_channel` raises, and every default set's is accepted.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu_torch.config import load_config
from encodec_pytorch_tpu_torch.data import CustomAudioDataset, MultiChannelAudioDataset
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.models.msstftd import MultiScaleSTFTDiscriminator
from encodec_pytorch_tpu_torch.train import trainer as trainer_module
from encodec_pytorch_tpu_torch.train.balancer import Balancer
from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step
from encodec_pytorch_tpu_torch.utils import write_wav
from test_torch_disc import close, rel_norm
from test_torch_train import DISC, TINY, WEIGHTS
from test_torch_train_bf16 import batches, jax_grads, jax_run, port_modules

torch.set_num_threads(1)


def _modules(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    model = EncodecModel._get_model(generator=gen, **TINY)
    disc = MultiScaleSTFTDiscriminator(generator=gen, **DISC)
    return model, disc, Balancer(WEIGHTS)


def _step(model, disc, balancer, opts, batch, **kw):
    return train_step(model, disc, balancer, *opts, torch.from_numpy(batch), n_q=2,
                      train_disc=True, lr_g=3e-4, lr_d=3e-4, sample_rate=24000,
                      generator=torch.Generator().manual_seed(1), **kw)


def _state(model, disc, opts, balancer):
    """Every tensor of the training state, in a fixed order."""
    out = [t.clone() for m in (model, disc) for t in m.state_dict().values()]
    for opt in opts:
        for p in opt.param_groups[0]['params']:
            out += [v.clone() for _, v in sorted(opt.state[p].items())]
    return out + [d[k].clone() for d in (balancer.total, balancer.fix) for k in sorted(d)]


def test_accumulation_of_duplicated_microbatches_equals_the_full_batch():
    # the JAX package's check's models (tests/test_train_step.py:220-227)
    gen = torch.Generator().manual_seed(0)
    model = EncodecModel._get_model([1.5, 3.], 24000, 1, causal=True,
                                    model_norm='weight_norm', audio_normalize=False,
                                    segment=None, n_q=2, n_filters=4, generator=gen)
    disc = MultiScaleSTFTDiscriminator(filters=4, n_ffts=(256, 128), hop_lengths=(64, 32),
                                       win_lengths=(256, 128), generator=gen)
    balancer = Balancer(WEIGHTS)
    model.quantizer.decay = 1.0
    gen = torch.Generator().manual_seed(7)
    for layer in model.quantizer.vq.layers:       # a bit-exact EMA fixed point
        cb = layer._codebook
        cb.inited.fill_(1)
        cb.cluster_size.fill_(16.)
        cb.embed.copy_(torch.randn(cb.embed.shape, generator=gen))
        cb.embed_avg.copy_(cb.embed * 16.)
    mb = batches(1)[0]
    batch = np.repeat(mb, 2, axis=0)              # batch[0::2] == batch[1::2] == mb
    runs = {}
    lr = 3e-4 * 1e-4              # the JAX check's schedule: step 0 of a 10-step warmup
    for accum in (1, 2):
        m, d, b = copy.deepcopy(model), copy.deepcopy(disc), copy.deepcopy(balancer)
        opts = (make_optimizer(m.parameters()), make_optimizer(d.parameters()))
        metrics = train_step(m, d, b, *opts, torch.from_numpy(batch), n_q=2, train_disc=True,
                             lr_g=lr, lr_d=lr, sample_rate=24000,
                             generator=torch.Generator().manual_seed(1), grad_accum_steps=accum)
        runs[accum] = (metrics, m, d)
    (m1, model1, disc1), (m2, model2, disc2) = runs[1], runs[2]
    for k in ('loss_g', 'loss_w', 'loss_disc', 'l_t', 'l_f', 'l_g', 'l_feat'):
        np.testing.assert_allclose(m2[k].item(), m1[k].item(), rtol=2e-4, atol=1e-5, err_msg=k)
    # the discriminator's loss is a batch mean: its gradient is the full
    # batch's. The generator's is not (each microbatch's balanced cotangent
    # has the full batch's per-item size, the commitment loss's does not, as
    # in the JAX step; test_accumulated_step_matches_jax holds it to JAX's)
    rel_norm(np.concatenate([p.grad.numpy().ravel() for p in disc2.parameters()]),
             np.concatenate([p.grad.numpy().ravel() for p in disc1.parameters()]), rel=2e-4)
    for a, b in ((model1, model2), (disc1, disc2)):
        for (name, p1), p2 in zip(a.named_parameters(), b.parameters()):
            np.testing.assert_allclose(p2.detach().numpy(), p1.detach().numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=name)
    for k, v in model.state_dict().items():          # the fixed point held in both
        if k.startswith('quantizer.'):
            assert torch.equal(model1.state_dict()[k], v)
            assert torch.equal(model2.state_dict()[k], v)


@pytest.fixture(scope='module')
def jax_accum():
    data = batches(1, size=8, seed=3)
    states, metrics, picks = jax_run(jnp.float32, 1, data, accum=4)
    return dict(state=states[0], new_state=states[1], metrics=metrics[0], batch=data[0],
                **picks[0])


def test_accumulated_step_matches_jax(jax_accum):
    j = jax_accum
    model, disc, sds = port_modules(j['state'], torch.float32)
    balancer = Balancer(WEIGHTS)
    opts = (make_optimizer(model.parameters()), make_optimizer(disc.parameters()))
    metrics = train_step(model, disc, balancer, *opts, torch.from_numpy(j['batch']),
                         n_q=j['n_q'], train_disc=j['coin'], lr_g=j['lr'], lr_d=j['lr'],
                         sample_rate=24000, draws=j['draws'], grad_accum_steps=4)
    for k in ('l_t', 'l_f', 'l_g', 'l_feat', 'loss_g', 'loss_w', 'loss_disc',
              'codebook_entropy', 'codebook_dead_frac'):
        close(metrics[k].item(), j['metrics'][k])
    new = j['new_state']
    for k in WEIGHTS:      # EMAs of gradient norms: the gradients' 1e-4
        close(balancer.total[k].item(), new.balancer.total[k], rel=1e-4)
        close(balancer.fix[k].item(), new.balancer.fix[k])
    grads = jax_grads(new)
    for k, v in model.state_dict().items():
        if k.startswith('quantizer.'):
            close(v.numpy(), grads['model'][k].numpy())
    for key, module in (('model', model), ('disc', disc)):
        named = list(module.named_parameters())
        rel_norm(np.concatenate([p.grad.numpy().ravel() for _, p in named]),
                 np.concatenate([grads[key][n].numpy().ravel() for n, _ in named]))


def test_guard_drops_a_nonfinite_step_and_keeps_a_clean_one():
    model, disc, balancer = _modules()
    opts = (make_optimizer(model.parameters()), make_optimizer(disc.parameters()))
    clean = batches(2)
    _step(model, disc, balancer, opts, clean[0], skip_nonfinite=True)    # k-means init
    before = _state(model, disc, opts, balancer)
    metrics = _step(model, disc, balancer, opts, np.full_like(clean[0], np.nan),
                    skip_nonfinite=True)
    assert metrics['skipped_nonfinite'].item() == 1.0
    after = _state(model, disc, opts, balancer)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    # a clean step: kept, and bit-equal to the same step without the guard
    twin = copy.deepcopy((model, disc, balancer, opts))
    metrics = _step(model, disc, balancer, opts, clean[1], skip_nonfinite=True)
    assert metrics['skipped_nonfinite'].item() == 0.0
    _step(*twin[:3], twin[3], clean[1])
    got = _state(model, disc, opts, balancer)
    assert all(torch.equal(a, b) for a, b in zip(got, _state(*twin[:2], twin[3], twin[2])))
    assert not all(torch.equal(a, b) for a, b in zip(got, before))
    # and the guard's state lives where Adam keeps it
    assert all(s['step'].item() == 2 for s in opts[0].state.values())


def test_trainer_config_keys_reach_the_step(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f'{i}.wav'))
        write_wav(paths[-1], rng.uniform(-0.3, 0.3, (1, 2400)).astype(np.float32), 24000)
    (tmp_path / 'data.csv').write_text('\n'.join(paths) + '\n')
    base = [f'datasets.train_csv_path={tmp_path / "data.csv"}',
            f'datasets.test_csv_path={tmp_path / "data.csv"}', 'datasets.tensor_cut=1200',
            'datasets.batch_size=2', 'common.max_epoch=1', 'model.n_filters=4', 'model.n_q=2',
            'model.filters=4', 'model.disc_n_ffts=[256]', 'model.disc_hop_lengths=[64]',
            'model.disc_win_lengths=[256]', 'lr_scheduler.warmup_epoch=0',
            f'checkpoint.save_folder={tmp_path}/']
    default = trainer_module.Trainer(load_config(base), device='cpu')
    assert (default.grad_accum_steps, default.skip_nonfinite) == (1, False)
    assert default.model.encoder.dtype == torch.bfloat16          # the yaml's default
    assert default.disc.discriminators[0].convs[0].dtype == torch.bfloat16
    f32 = trainer_module.Trainer(load_config(base + ['tpu.compute_dtype=float32']), device='cpu')
    assert f32.model.encoder.dtype == f32.disc.discriminators[0].convs[0].dtype == torch.float32

    seen = []
    real = trainer_module.train_step

    def spy(*args, **kwargs):
        seen.append((kwargs['grad_accum_steps'], kwargs['skip_nonfinite']))
        return real(*args, **kwargs)

    monkeypatch.setattr(trainer_module, 'train_step', spy)
    trainer = trainer_module.Trainer(load_config(base + [
        'tpu.grad_accum_steps=2', 'tpu.skip_nonfinite_steps=true']), device='cpu')
    assert (trainer.grad_accum_steps, trainer.skip_nonfinite) == (2, True)
    summary = trainer.train_one_epoch(1)
    assert seen == [(2, True)] * 2 and summary['skipped_nonfinite'] == 0.0
    with pytest.raises(ValueError, match='grad_accum_steps'):
        trainer_module.Trainer(load_config(base + ['tpu.grad_accum_steps=3']), device='cpu')
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        trainer_module.Trainer(load_config(base + ['tpu.compute_dtype=float16']), device='cpu')


@pytest.mark.parametrize('dataset', ['unknown'])
def test_trainer_refuses_a_dataset_it_does_not_run(dataset):
    """A ``datasets.dataset`` the port does not have raises before a dataset
    is built, instead of training on the CSV set."""
    config = load_config([f'datasets.dataset={dataset}'])
    with pytest.raises(NotImplementedError, match="runs \\['csv', 'multi_channel'\\]"):
        trainer_module.check_supported(config)
    with pytest.raises(NotImplementedError, match='not ported yet'):
        trainer_module.Trainer(config, device='cpu')
    trainer_module.check_supported(load_config(['datasets.dataset=csv']))
    trainer_module.check_supported(load_config())


@pytest.mark.parametrize('name', ['config', 'config_48k_stereo', 'config_mono_nq2',
                                  'config_mono_nq2_resume'])
def test_trainer_accepts_the_datasets_of_every_set(name):
    """``check_supported`` accepts every default set (the mono-nq2 sets' dataset
    is ``multi_channel``), and maps it to the dataset class ``build_dataset`` builds."""
    config = load_config(name=name)
    trainer_module.check_supported(config)
    trainer_module.check_supported(load_config(['datasets.dataset=multi_channel']))
    assert trainer_module.DATASETS[config.datasets.dataset] is (
        MultiChannelAudioDataset if name.startswith('config_mono_nq2') else CustomAudioDataset)
