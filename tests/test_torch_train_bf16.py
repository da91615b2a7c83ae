"""One bfloat16 training step of the port against the JAX package's bf16 step,
on the CPU, from the same state.

The setting is tests/test_torch_train.py's (tiny widths, one SEANet stage,
volume normalization, the discriminator on its plain path, no LR warmup, the
JAX step's random choices handed to the port), with both models and both
discriminators built in bfloat16: bf16 activations, f32 master weights, f32
in the LSTM, the quantizer and the losses. The two frameworks round bf16
activations in different places (see tests/test_torch_bf16.py), so the
comparison uses bf16 tolerances:

- losses: within 2e-2 relative (measured: at most 2.4e-3, l_f);
- the generator's gradients: within 1e-2 by relative norm of the JAX bf16
  step's (measured: 4.3e-3);
- the discriminator's gradients: XLA's CPU bf16 convolutions and sums put
  the JAX bf16 step's 0.36 by relative norm from its own f32 step's, so the
  port's are held to the JAX f32 step's instead: within 1e-1 (measured:
  0.068), and closer to them than the JAX bf16 step's are;
- the master parameters stay float32, and every element with a gradient moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from encodec_pytorch_tpu.convert import msstftd_params_from_torch
from encodec_pytorch_tpu.models.model import variables_from_torch_state_dict
from encodec_pytorch_tpu.models.msstftd import MultiScaleSTFTDiscriminator as JaxDisc
from encodec_pytorch_tpu.train.schedule import warmup_cosine_schedule as jax_schedule
from encodec_pytorch_tpu.train.step import TrainState, build_train_step
from encodec_pytorch_tpu_torch import convert
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.models.msstftd import MultiScaleSTFTDiscriminator
from encodec_pytorch_tpu_torch.train.balancer import Balancer
from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step
from test_torch_disc import rel_norm
from test_torch_train import (DISC, TINY, WEIGHTS, _CapturedModel, _MonitoredBalancer,
                              jax_stage_draws)

torch.set_num_threads(1)

BF16 = torch.bfloat16


def jax_run(dtype, steps: int, batches, key=jax.random.PRNGKey(2), accum: int = 1):
    """``steps`` jitted JAX steps in ``dtype`` from the port's seeded init
    (tests/test_torch_train.py's fixture, with a dtype and several steps):
    the states, the metrics, and the random choices of each step (n_q, coin,
    the RVQ draws for a microbatch of ``len(batch) / accum`` rows)."""
    jm = _CapturedModel._get_model(segment=None, dtype=dtype, **TINY)
    jd = JaxDisc(fpack=0, dtype=dtype, **DISC)
    sched = jax_schedule(3e-4, max_iter=100, eta_ratio=0.1, warmup_iter=0, warmup_ratio=1e-4)
    jb = _MonitoredBalancer(WEIGHTS)
    step_fn = build_train_step(jm, jd, jb, sched, sched, disc_prob=1.0, sample_rate=24000,
                               grad_accum_steps=accum)
    gen = torch.Generator().manual_seed(8)
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
    args = (state, jnp.asarray(batches[0]), key, jnp.asarray(True))
    step = jax.jit(step_fn).lower(*args).compile({'xla_backend_optimization_level': 0})

    @jax.jit
    def choices(key, i):
        rng_bw, rng_coin = jax.random.split(jax.random.fold_in(key, i))
        k_bw, k_q = jax.random.split(rng_bw)
        return (jax.random.randint(k_bw, (), 0, 2), jax.random.uniform(rng_coin) < 1.0,
                jax.random.fold_in(k_q, 0))

    states, metrics, picks = [jax.device_get(state)], [], []
    for i in range(steps):
        new, m = step(states[-1], jnp.asarray(batches[i]), key, jnp.asarray(True))
        states.append(jax.device_get(new))
        metrics.append(jax.device_get(m))
        bw_index, coin, k_q = choices(key, i)
        rows = len(batches[i]) // accum * batches[i].shape[-1] // 8
        picks.append(dict(n_q=int(jm.n_q_for_bandwidth_index()[int(bw_index)]),
                          coin=bool(coin), draws=jax_stage_draws(k_q, TINY['n_q'], rows, 1024),
                          lr=float(sched(i))))
    return states, metrics, picks


def port_modules(state, dtype):
    """The port's modules in ``dtype`` in the state of a JAX ``TrainState``."""
    sds = convert.train_state_from_jax(state, DISC['win_lengths'])
    model = EncodecModel._get_model(dtype=dtype, **TINY)
    model.load_state_dict(sds['model'], strict=True)
    disc = MultiScaleSTFTDiscriminator(dtype=dtype, **DISC)
    disc.load_state_dict(sds['disc'], strict=True)
    return model, disc, sds


def batches(n: int, size: int = 2, seed: int = 8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((size, 1, 1200)).astype(np.float32) * 0.1 for _ in range(n)]


def jax_grads(state):
    """The gradients of a JAX step's update (Adam's first moment after one
    step is (1 - b1) g), as the port's state dicts."""
    return convert.train_state_from_jax(state._replace(
        params_g=jax.tree.map(lambda m: m / 0.5, state.opt_g.mu),
        params_d=jax.tree.map(lambda m: m / 0.5, state.opt_d.mu)), DISC['win_lengths'])


@pytest.fixture(scope='module')
def jax_bf16_step():
    """One JAX step in bf16, and the discriminator's gradients of the same
    step in f32."""
    data = batches(1)
    states, metrics, picks = jax_run(jnp.bfloat16, 1, data)
    f32_states, _, _ = jax_run(jnp.float32, 1, data)
    return dict(state=states[0], new_state=states[1], metrics=metrics[0], batch=data[0],
                f32_grads=jax_grads(f32_states[1]), **picks[0])


def test_bf16_train_step_matches_jax(jax_bf16_step):
    j = jax_bf16_step
    model, disc, sds = port_modules(j['state'], BF16)
    before = {'model': {k: v.clone() for k, v in model.state_dict().items()},
              'disc': {k: v.clone() for k, v in disc.state_dict().items()}}
    metrics = train_step(model, disc, Balancer(WEIGHTS), make_optimizer(model.parameters()),
                         make_optimizer(disc.parameters()), torch.from_numpy(j['batch']),
                         n_q=j['n_q'], train_disc=j['coin'], lr_g=j['lr'], lr_d=j['lr'],
                         sample_rate=24000, draws=j['draws'])
    for k in ('l_t', 'l_f', 'l_g', 'l_feat', 'loss_g', 'loss_disc'):
        np.testing.assert_allclose(metrics[k].item(), float(j['metrics'][k]), rtol=2e-2,
                                   err_msg=k)
    grads = jax_grads(j['new_state'])
    flat = lambda sd, named: np.concatenate([sd[n].numpy().ravel() for n, _ in named])
    for key, module in (('model', model), ('disc', disc)):
        named = list(module.named_parameters())
        got = np.concatenate([p.grad.numpy().ravel() for _, p in named])
        if key == 'model':
            rel_norm(got, flat(grads[key], named), rel=1e-2)
        else:
            ref32 = flat(j['f32_grads'][key], named)
            rel_norm(got, ref32, rel=1e-1)
            jax16 = flat(grads[key], named)
            assert np.linalg.norm(got - ref32) < np.linalg.norm(jax16 - ref32)
        for name, p in named:
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
            moved = p.detach() != before[key][name]
            assert torch.equal(moved, p.grad != 0), name      # where a gradient is
