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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu_torch.train.balancer import Balancer
from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step
from test_torch_train import WEIGHTS
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
