"""A 3-step loss trajectory of the port's training step against the JAX
package's ``build_train_step``, on the CPU, in float32 and in bfloat16.

tests/test_trajectory_parity.py holds the JAX package to the reference torch
trainer, which is not in the repository; this file takes the JAX step as the reference
instead. Both start from the port's seeded init (carried to JAX by the JAX
package's converters) with empty codebooks (the first step runs the k-means
init), at tests/test_torch_train.py's tiny widths, and take 3 steps on 3
seeded batches; each step's random choices (bandwidth, disc coin, RVQ draws)
are the JAX step's, handed to the port, whose modules, Adam states and
balancer carry from step to step. Each step's losses agree within a
relative bound (plus 1e-7 absolute):

- float32: within 1e-4 relative (measured: at most 2.5e-6);
- bfloat16: within 2e-2 relative (measured: at most 4.9e-3, loss_w).

At ``TINY``'s rates every bandwidth draws one codebook. The mono-nq2 mode
(``config_mono_nq2``) has two, and its bandwidths ask for n_q 2, 4, 8, 16 and
32 (both stages run, the commitment penalty divided by the n_q asked for);
it updates the discriminator on half its steps. Its case takes a generator
of two stages whose bandwidths ask for n_q 2 and 4 (60 and 120 kbps at one
SEANet stage's 3000 frames a second) for two f32 steps: n_q 2 with the
discriminator's update, then n_q 4 without. It holds each step's losses, the
generator's gradients and (on the first) the discriminator's to the f32 bar,
1e-4 relative (gradients by relative norm, from the JAX step's Adam
moments; measured: losses 4.8e-7, the generator's gradients 4.9e-7, the
discriminator's 4.0e-6), and the discriminator after the second step
bit-equal to before it in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu_torch import convert
from encodec_pytorch_tpu_torch.train.balancer import Balancer
from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step
from test_torch_disc import rel_norm
from test_torch_train import DISC, TINY, WEIGHTS
from test_torch_train_bf16 import batches, jax_run, port_modules

torch.set_num_threads(1)

STEPS = 3
LOSSES = ('l_t', 'l_f', 'l_g', 'l_feat', 'loss_g', 'loss_w', 'loss_disc')


@pytest.mark.parametrize('dtype,rel', [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=['float32', 'bfloat16'])
def test_three_step_loss_trajectory_matches_jax(dtype, rel):
    data = batches(STEPS, seed=11)
    states, metrics, picks = jax_run({torch.float32: jnp.float32,
                                      torch.bfloat16: jnp.bfloat16}[dtype], STEPS, data)
    model, disc, _ = port_modules(states[0], dtype)
    balancer = Balancer(WEIGHTS)
    opt_g, opt_d = make_optimizer(model.parameters()), make_optimizer(disc.parameters())
    for i in range(STEPS):
        pick = picks[i]
        got = train_step(model, disc, balancer, opt_g, opt_d, torch.from_numpy(data[i]),
                         n_q=pick['n_q'], train_disc=pick['coin'], lr_g=pick['lr'],
                         lr_d=pick['lr'], sample_rate=24000, draws=pick['draws'])
        for k in LOSSES:
            np.testing.assert_allclose(got[k].item(), float(metrics[i][k]), rtol=rel,
                                       atol=1e-7, err_msg=f'step {i + 1} {k}')


NQ2 = dict(TINY, target_bandwidths=[60., 120.])


def _adam_grads(states, i: int):
    """The gradients of step ``i`` of a JAX run (0-based), from Adam's first
    moments (b1 0.5): ``g = (mu_{i+1} - 0.5 mu_i) / 0.5``, as the port's state
    dicts."""
    before, after = states[i], states[i + 1]
    grad = lambda a, b: jax.tree.map(lambda m1, m0: (m1 - 0.5 * m0) / 0.5, a.mu, b.mu)
    return convert.train_state_from_jax(after._replace(
        params_g=grad(after.opt_g, before.opt_g), params_d=grad(after.opt_d, before.opt_d)),
        DISC['win_lengths'])


def test_nq2_steps_with_and_without_the_disc_update_match_jax():
    data = batches(2, seed=13)
    states, metrics, picks = jax_run(jnp.float32, 2, data, key=jax.random.PRNGKey(5),
                                     disc_allowed=(True, False), tiny=NQ2)
    assert [(p['n_q'], p['coin']) for p in picks] == [(2, True), (4, False)]
    model, disc, _ = port_modules(states[0], torch.float32, tiny=NQ2)
    balancer = Balancer(WEIGHTS)
    opt_g, opt_d = make_optimizer(model.parameters()), make_optimizer(disc.parameters())
    flat = lambda sd, named: np.concatenate([sd[n].numpy().ravel() for n, _ in named])
    for i, pick in enumerate(picks):
        disc_before = [p.detach().clone() for p in disc.parameters()]
        got = train_step(model, disc, balancer, opt_g, opt_d, torch.from_numpy(data[i]),
                         n_q=pick['n_q'], train_disc=pick['coin'], lr_g=pick['lr'],
                         lr_d=pick['lr'], sample_rate=24000, draws=pick['draws'])
        for k in LOSSES:
            np.testing.assert_allclose(got[k].item(), float(metrics[i][k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f'step {i + 1} {k}')
        grads = _adam_grads(states, i)
        trained = [('model', model)] + ([('disc', disc)] if pick['coin'] else [])
        for key, module in trained:
            named = list(module.named_parameters())
            rel_norm(np.concatenate([p.grad.numpy().ravel() for _, p in named]),
                     flat(grads[key], named), rel=1e-4)
        if not pick['coin']:
            assert all(torch.equal(a, b) for a, b in zip(disc.parameters(), disc_before))
            assert all(np.array_equal(a, b) for a, b in zip(
                jax.tree.leaves(states[i].params_d), jax.tree.leaves(states[i + 1].params_d)))
