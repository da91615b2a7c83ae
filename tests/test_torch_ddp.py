"""Data-parallel training of the port (``parallel/mesh.py`` and the ``dp``
paths of the step, the quantizer, the balancer and the losses) on the CPU:
2 ranks over gloo, each a subprocess (``tests/torch_ddp_steps.py``) that
joins at a ``file://`` rendezvous under ``tmp_path`` and runs on its rows of
the global batch, against the one-process port step on the global batch and
against the JAX step over a 2-device mesh.

- Step parity, ``grad_accum_steps`` 1 (global batch 4) and 2 (global batch
  8): two steps from the seeded init, the first with the k-means init of
  all 4 stages and the dead-code expiry and no discriminator update, the
  second at n_q 2 with one. Every group of the state (parameters and
  buffers, codebooks, Adam's moments and step counts, the balancer's EMA)
  within 1e-5 by relative norm of the one-process state (measured: at most
  9.8e-7, the balancer's EMA at accumulation 2; the parameters 7.5e-7), at
  least 0.999 of the codes equal (measured: all), and the ranks' states
  equal bit for bit.
  At accumulation 2 a global batch of 8 gives each rank's microbatch 2 rows:
  with 1 row (global batch 4) the CPU's convolutions (oneDNN) and the LSTM's
  recurrence (a matrix-vector product) round 1 ulp differently from the
  one-process step's 2-row calls, and the k-means over 1200 rows and 1024
  bins turns that into flipped codes, far past both bars, which says
  nothing of the data-parallel step.
- JAX: the 2-rank state after each of two steps (``PRNGKey(0)``'s choices:
  n_q 4 with the k-means init and expiry, then n_q 2 with the discriminator
  update; the JAX draws handed to the port) against the JAX step on a
  2-device mesh of the conftest's virtual devices, one compiled step: the
  parameters, the codebooks and the balancer's EMA within 1e-5 by relative
  norm (measured: 5.6e-7, 1.7e-8, 2.2e-7), Adam's moments within 1e-4, the
  gradients' bar of tests/test_torch_train.py (measured: 5.5e-6).
- The guard: a NaN in rank 1's rows alone makes both ranks skip the step,
  their states bit-equal to before it; ``DataParallel.all_`` is every
  rank's AND.
- The loader's shards equal the JAX ``DataLoader``'s ``_indices()``, and
  its length the JAX one's.
- The trainer refuses a config the launcher contradicts, before it starts a
  process group; ``--device cuda`` under torchrun is ``cuda:LOCAL_RANK``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ddp_steps as steps
from encodec_pytorch_tpu.convert import msstftd_params_from_torch
from encodec_pytorch_tpu.data.dataset import DataLoader as JaxLoader
from encodec_pytorch_tpu.models.model import EncodecModel as JaxModel
from encodec_pytorch_tpu.models.model import variables_from_torch_state_dict
from encodec_pytorch_tpu.models.msstftd import MultiScaleSTFTDiscriminator as JaxDisc
from encodec_pytorch_tpu.parallel.mesh import batch_sharding, create_mesh, replicated_sharding
from encodec_pytorch_tpu.train.balancer import Balancer as JaxBalancer
from encodec_pytorch_tpu.train.schedule import warmup_cosine_schedule as jax_schedule
from encodec_pytorch_tpu.train.step import TrainState, build_train_step
from encodec_pytorch_tpu_torch import convert
from encodec_pytorch_tpu_torch.config import load_config
from encodec_pytorch_tpu_torch.data import DataLoader
from encodec_pytorch_tpu_torch.parallel import local_device
from encodec_pytorch_tpu_torch.train import trainer as trainer_module
from test_torch_train import jax_stage_draws

torch.set_num_threads(1)

REL = 1e-5
CODES_SHARE = 0.999
JAX_REL = {'parameters': 1e-5, 'codebooks': 1e-5, 'adam': 1e-4, 'balancer': 1e-5}
RANK_TIMEOUT = 120
KEY = jax.random.PRNGKey(0)


def _steps_from_seed():
    return [dict(n_q=4, train_disc=False, lr=3e-4, batch_seed=1),
            dict(n_q=2, train_disc=True, lr=3e-4, batch_seed=2)]


def _jax_choices(sched, rows: int):
    """The JAX step's n_q, coin and RVQ draws for each of two steps from
    ``KEY`` (the discriminator allowed on the second only)."""
    @jax.jit
    def choices(key, i):
        rng_bw, rng_coin = jax.random.split(jax.random.fold_in(key, i))
        k_bw, k_q = jax.random.split(rng_bw)
        return jax.random.randint(k_bw, (), 0, 2), jax.random.fold_in(k_q, 0)

    out = []
    for i, allowed in enumerate((False, True)):
        bw_index, k_q = choices(KEY, i)
        out.append(dict(n_q=(2, 4)[int(bw_index)], train_disc=allowed, lr=float(sched(i)),
                        batch_seed=10 + i,
                        draws=jax_stage_draws(k_q, steps.TINY['n_q'], rows, 1024)))
    return out


def _jax_states(sched, jax_steps):
    """Two steps of the JAX step from the port's seeded init, jitted over a
    2-device mesh (batch sharded, state replicated): the state after each,
    as the port's named tensors."""
    jm = JaxModel._get_model(segment=None, **steps.TINY)
    jm.quantizer = dataclasses.replace(jm.quantizer, kmeans_iters=steps.KMEANS_ITERS)
    jd = JaxDisc(fpack=0, **steps.DISC)
    jb = JaxBalancer(steps.WEIGHTS)
    step_fn = build_train_step(jm, jd, jb, sched, sched, disc_prob=1.0, sample_rate=24000)
    model, disc = steps.modules()
    numpy_sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    variables = jax.device_get(variables_from_torch_state_dict(jm, numpy_sd(model)))
    params_d = jax.device_get(msstftd_params_from_torch(numpy_sd(disc)))
    adam0 = lambda p: optax.ScaleByAdamState(np.zeros((), np.int32), *(
        jax.tree.map(np.zeros_like, p) for _ in range(2)))
    state = TrainState(variables['params'], params_d, variables['quantizer'],
                       adam0(variables['params']), adam0(params_d),
                       jax.device_get(jb.init_state()), np.zeros((), np.int32))
    mesh = create_mesh(2)
    repl, shard = replicated_sharding(mesh), batch_sharding(mesh)
    batches = [jax.device_put(steps.global_batch(s['batch_seed']), shard) for s in jax_steps]
    allowed = [jax.device_put(jnp.asarray(s['train_disc']), repl) for s in jax_steps]
    state, key = jax.device_put(state, repl), jax.device_put(KEY, repl)
    step = jax.jit(step_fn, in_shardings=(repl, shard, repl, repl),
                   out_shardings=(repl, repl)).lower(state, batches[0], key, allowed[0]).compile(
        {'xla_backend_optimization_level': 0})
    out = []
    for batch, ok in zip(batches, allowed):
        state, _ = step(state, batch, key, ok)
        sds = convert.train_state_from_jax(jax.device_get(state), steps.DISC['win_lengths'])
        named = {f'{m}/{k}': v for m in ('model', 'disc') for k, v in sds[m].items()}
        for m in ('adam_g', 'adam_d'):
            for k in ('exp_avg', 'exp_avg_sq'):
                named.update({f'{m}/{k}/{n}': v for n, v in sds[m][k].items()})
        for k in ('total', 'fix'):
            named.update({f'balancer/{k}/{n}': v for n, v in sds['balancer'][k].items()})
        out.append(named)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The 2-rank runs of every scenario and the one-process runs of the
    parity scenarios on the global batches (three subprocesses, started
    first), and the JAX step's states on a 2-device mesh (compiled while they
    run)."""
    tmp = tmp_path_factory.mktemp('ddp')
    sched = jax_schedule(3e-4, max_iter=100, eta_ratio=0.1, warmup_iter=0, warmup_ratio=1e-4)
    frames = steps.LENGTH // 16
    jax_steps = _jax_choices(sched, 4 * frames)
    spec = {
        'accum1': dict(batch=4, accum=1, seed=5, steps=_steps_from_seed()),
        'accum2': dict(batch=8, accum=2, seed=5, steps=_steps_from_seed()),
        'guard': dict(batch=4, accum=1, seed=5, steps=[
            dict(n_q=4, train_disc=True, lr=3e-4, batch_seed=1, skip_nonfinite=True),
            dict(n_q=4, train_disc=True, lr=3e-4, batch_seed=3, nan_rows=[2, 3],
                 skip_nonfinite=True)]),
        'jax': dict(batch=4, accum=1, seed=0, steps=jax_steps),
    }
    torch.save(spec, tmp / 'spec.pt')
    torch.save({name: spec[name] for name in ('accum1', 'accum2')}, tmp / 'single.pt')
    procs = (steps.launch(str(tmp / 'spec.pt'), str(tmp / 'rank'))
             + steps.launch(str(tmp / 'single.pt'), str(tmp / 'single'), world=1))
    try:
        jax_states = _jax_states(sched, jax_steps)
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:        # a rank left waiting for a failed one, or the JAX step failed
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, out[-2000:], err[-4000:])
    ranks = [torch.load(tmp / f'rank{r}.pt', weights_only=True) for r in range(2)]
    return dict(ranks=ranks, single=torch.load(tmp / 'single0.pt', weights_only=True),
                jax=jax_states)


def _group(name: str) -> str:
    if name.startswith('model/quantizer.'):
        return 'codebooks'
    if name.startswith(('adam_g/', 'adam_d/')):
        return 'adam'
    return name.split('/')[0] if name.startswith('balancer/') else 'parameters'


def _rel_by_group(got: dict, want: dict) -> dict:
    """Relative norm of ``got - want`` over each group of ``want``'s tensors."""
    diff, norm = {}, {}
    for k, w in want.items():
        g, w = _group(k), w.double()
        diff[g] = diff.get(g, 0.0) + float(torch.sum(torch.square(got[k].double() - w)))
        norm[g] = norm.get(g, 0.0) + float(torch.sum(torch.square(w)))
    return {g: (diff[g] / norm[g]) ** 0.5 if norm[g] else diff[g] ** 0.5 for g in diff}


def _assert_ranks_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


@pytest.mark.parametrize('name', ['accum1', 'accum2'])
def test_two_ranks_equal_the_global_batch_step(runs, name):
    r0, r1 = (r[name] for r in runs['ranks'])
    single = runs['single'][name]
    for s, want in enumerate(single['states']):
        _assert_ranks_equal(r0['states'][s], r1['states'][s])
        assert r0['states'][s].keys() == want.keys()
        rel = _rel_by_group(r0['states'][s], want)
        assert max(rel.values()) <= REL, (s, rel)
        for a, (c0, c1, c) in enumerate(zip(r0['codes'][s], r1['codes'][s], single['codes'][s])):
            joined = torch.cat([c0, c1], dim=1)        # rank order: the global microbatch
            flips = (joined != c).nonzero().tolist()
            assert 1 - len(flips) / c.numel() >= CODES_SHARE, (s, a, flips[:20])
        for k in ('loss_g', 'loss_w', 'loss_disc', 'l_feat', 'balanced_grad_norm'):
            np.testing.assert_allclose(r0['metrics'][s][k], single['metrics'][s][k], rtol=1e-5,
                                       err_msg=k)
        assert r0['metrics'][s] == r1['metrics'][s]
    # the steps ran what they claim: the k-means init and expiry, then the disc
    first, second = single['states']
    assert all(first[f'model/quantizer.vq.layers.{k}._codebook.inited'] == 1 for k in range(4))
    assert (first['model/quantizer.vq.layers.0._codebook.cluster_size'] < 2).any()
    assert 'adam_d/exp_avg/discriminators.0.convs.0.conv.bias' not in first
    assert 'adam_d/exp_avg/discriminators.0.convs.0.conv.bias' in second


def test_two_ranks_equal_the_jax_step_on_a_two_device_mesh(runs):
    r0, r1 = (r['jax'] for r in runs['ranks'])
    for s, want in enumerate(runs['jax']):
        _assert_ranks_equal(r0['states'][s], r1['states'][s])
        got = r0['states'][s]
        # every tensor but Adam's step counts; the JAX Adam state also holds
        # moments of the LSTM's summed bias, whose second half is a buffer here
        assert {k for k in got if '/step/' not in k} <= set(want)
        assert all(k.startswith(('adam_g/', 'adam_d/')) for k in set(want) - set(got))
        rel = _rel_by_group(got, {k: v for k, v in want.items() if k in got})
        assert set(rel) == set(JAX_REL), rel
        assert all(rel[g] <= JAX_REL[g] for g in rel), (s, rel)


def test_guard_skips_on_every_rank_when_one_rank_is_not_finite(runs):
    r0, r1 = (r['guard'] for r in runs['ranks'])
    for r in (r0, r1):
        assert [m['skipped_nonfinite'] for m in r['metrics']] == [0.0, 1.0]
        _assert_ranks_equal(r['states'][1], r['states'][0])
        assert r['all_finite'] is False
    _assert_ranks_equal(r0['states'][0], r1['states'][0])


class _Items:
    """A dataset of ``n`` items (only its length and epoch matter here)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass


@pytest.mark.parametrize('num_shards', [1, 2, 3])
def test_loader_shards_equal_jax(num_shards):
    for n, batch, shuffle in ((10, 2, True), (13, 2, True), (9, 1, False)):
        for shard in range(num_shards):
            ours = DataLoader(_Items(n), batch, seed=3401, shuffle=shuffle, shard_id=shard,
                              num_shards=num_shards)
            ref = JaxLoader(_Items(n), batch, shuffle=shuffle, seed=3401, shard_id=shard,
                            num_shards=num_shards, prefetch=0)
            for epoch in (1, 2):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                assert ours._indices() == ref._indices()
                assert len(ours) == len(ref)
        every = [i for s in range(num_shards)
                 for i in DataLoader(_Items(n), batch, seed=3401, shuffle=shuffle, shard_id=s,
                                     num_shards=num_shards)._indices()]
        assert sorted(every) == list(range(n))            # disjoint, all of them


@pytest.mark.parametrize('overrides, world, match', [
    (['--config', 'config_mono_nq2'], 2, 'data_parallel is False, but the launcher started 2'),
    (['distributed.world_size=3'], 2, 'world_size=3, but the launcher started 2'),
    (['datasets.batch_size=12'], 5, 'batch_size 12 must divide over 5'),
    (['tpu.grad_accum_steps=4'], 2, r'12 must divide over 2 process\(es\) and then tpu.grad_accum_steps=4'),
], ids=['data_parallel_false', 'world_size', 'batch', 'accumulation'])
def test_trainer_refuses_what_the_launcher_contradicts(overrides, world, match, monkeypatch):
    """Each refusal raises in ``check_supported`` and in the trainer before a
    process group starts (none could: no rendezvous is set)."""
    name = overrides[1] if overrides[0] == '--config' else 'config'
    config = load_config([o for o in overrides if '=' in o], name)
    monkeypatch.setenv('WORLD_SIZE', str(world))
    with pytest.raises(ValueError, match=match):
        trainer_module.check_supported(config)
    with pytest.raises(ValueError, match=match):
        trainer_module.Trainer(config, device='cpu')


def test_launcher_settings_are_accepted(monkeypatch):
    """``world_size`` 0 takes every process and a matching one is accepted;
    ``--device cuda`` is ``cuda:LOCAL_RANK`` (0 without a launcher)."""
    trainer_module.check_supported(load_config(), world=2)
    trainer_module.check_supported(load_config(['distributed.world_size=4']), world=4)
    trainer_module.check_supported(load_config(name='config_mono_nq2'), world=1)
    assert local_device('cuda') == torch.device('cuda', 0)
    monkeypatch.setenv('LOCAL_RANK', '3')
    assert local_device('cuda') == torch.device('cuda', 3)
    assert local_device('cuda:1') == torch.device('cuda', 1)
    assert local_device('cpu') == torch.device('cpu')
