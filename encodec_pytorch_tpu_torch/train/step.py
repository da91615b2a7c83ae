"""The GAN training step.

Port of ``build_train_step`` of ``encodec_pytorch_tpu/train/step.py`` on the
path the JAX trainer ships: per-path loss gradients sharing one fake
discriminator forward (``shared_disc_vjp``), sequential per-loss gradients
(``balancer_vjp_chunk`` 1), with its two options, gradient accumulation
(``grad_accum_steps``, ``_build_accum_step``) and the non-finite step guard
(``skip_nonfinite``). One step, on each of ``grad_accum_steps`` interleaved
microbatches ``batch[a::N]`` in turn (one, the whole batch, by default):

1. The generator output is computed once (``model.forward_train``; the
   codebook EMA advances in place, once a microbatch), together with the
   commitment loss ``loss_w``.
2. The gradient of each loss with respect to the output comes from
   ``torch.autograd.grad`` on a detached copy of it: ``l_t`` and ``l_f``
   through the waveform, ``l_g`` and ``l_feat`` through one discriminator
   forward on the fake, run with the discriminator's parameters frozen so
   that no weight gradient is computed there (the JAX package's path-split
   VJPs skip that work too). The real forward's feature maps are constants.
3. The balancer combines the four gradients into one cotangent (its EMA
   advancing once a microbatch, weighted by the microbatch's size), and one
   ``backward`` of (output, loss_w) with (cotangent, 1) adds the generator's
   gradients to ``.grad``.
4. When the caller's ``train_disc`` is set (epoch past warmup and the coin
   came up), the hinge loss of the real and the detached fake logits is
   backpropagated into the discriminator's ``.grad``.

Then the summed gradients are divided by N, Adam (β 0.5/0.9, ε 1e-8, the
same update as ``optax.scale_by_adam``) steps the generator with the learning
rate the schedule gives for this step, and, when ``train_disc`` is set, the
discriminator. Only one microbatch's activations are alive at a time. The JAX
accumulated step always computes the discriminator's update and masks it;
computing it only when it is applied leaves the same state. With one
microbatch this is the JAX plain step.

The step draws nothing itself: the caller passes ``n_q`` (from the random
bandwidth) and ``train_disc``, once a step, and the RVQ draws come from
``generator`` (or ``draws``, used for every microbatch as the JAX step uses
one key for all of them), so tests can feed in the JAX package's choices.

The compute dtype is the modules' own (``dtype`` of the model and the
discriminator): in bf16 the forward runs bf16 activations, the model's output
and the losses stay f32 (the balancer differentiates them with respect to
that f32 output, as the JAX step does), and the gradients land on the f32
master parameters through the casts.

The guard (``skip_nonfinite``, ``train/step.py:321-342`` of the JAX
package): before the step the state it may revert is copied on the device
(parameters, Adam's moments and step counts, the codebook buffers, the
balancer's EMA); after it, one finite check over every loss and every updated
parameter and codebook buffer decides, with ``torch.where``, whether each
tensor keeps its new value or takes back its copy. The step counts of the
schedules advance either way (the caller's). ``skipped_nonfinite`` is 1 when
the update was dropped. Nothing is read on the host: on CUDA Adam must keep
its step counts on the card (:func:`make_optimizer` with ``capturable``).

Data parallelism (``dp``, a :class:`~..parallel.mesh.DataParallel`; the
JAX step's SPMD semantics, ``train/step.py:1-14`` of the JAX package): each
rank passes its rows of the global batch, ``[r·B/n, (r+1)·B/n)``, and its
microbatch ``a`` is ``local[a::N]``, which joined in rank order is the global
microbatch ``batch[a::N]``. Every rank then computes what a one-process step
computes on the global batch: the quantizer's EMA, k-means and expiry and the
balancer run on global statistics (``core_vq``, ``balancer``), ``l_feat``'s
denominators are global (``losses``), each loss's cotangent and the
commitment loss's are ``1/n`` (the global loss is the ranks' mean), and after
the last microbatch the generator's and the discriminator's gradients are
summed over the ranks, a flat all-reduce a module (the JAX step's psum; no
``DistributedDataParallel``, whose reducer expects one backward through
``forward``, while this step differentiates through a frozen discriminator and
runs a manual backward of the generator). The metrics are global means, and the
guard's flag is every rank's AND, so every rank keeps or reverts the same
update. The caller draws ``n_q``, ``train_disc`` and the RVQ draws alike on
every rank (the same seeds); every rank then ends the step with the same
state, bit for bit.

:func:`eval_step` is the test loop's step, without gradients.
"""

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from ..models.model import EncodecModel
from ..models.msstftd import MultiScaleSTFTDiscriminator
from ..parallel.mesh import DataParallel
from ..quantization.core_vq import codebook_metrics
from .balancer import Balancer
from .losses import disc_loss, gan_losses, wav_losses

LOSSES = ('l_f', 'l_feat', 'l_g', 'l_t')


def make_optimizer(params, capturable: bool = False) -> torch.optim.Adam:
    """Adam(betas=(0.5, 0.9), eps=1e-8); the learning rate is set each step.
    ``capturable`` keeps Adam's step count on the parameters' device (CUDA
    only), so that the non-finite guard can revert it without a host sync."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.5, 0.9), eps=1e-8, capturable=capturable)


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group['lr'] = lr


def _microbatch(model: EncodecModel, disc: MultiScaleSTFTDiscriminator, balancer: Balancer,
                batch: torch.Tensor, n_q: int, train_disc: bool, sample_rate: int,
                generator: Optional[torch.Generator],
                draws: Optional[Sequence[Dict[str, torch.Tensor]]],
                dp: Optional[DataParallel]) -> Dict[str, torch.Tensor]:
    """Steps 1-4 on one microbatch: adds its gradients (under ``dp``, this
    rank's share of the global microbatch's) to ``.grad`` and returns its
    losses (detached; under ``dp`` this rank's, and for the balanced
    cotangent the squared norm of its rows)."""
    output, loss_w = model.forward_train(batch, n_q, generator, draws, dp)
    out = output.detach().requires_grad_()
    share = loss_w.new_full((), 1.0 / dp.world if dp is not None else 1.0)

    with contextlib.nullcontext() if train_disc else torch.no_grad():
        logits_real, fmap_real = disc(batch)
    fmap_real = [[f.detach() for f in fm] for fm in fmap_real]
    with _frozen(disc):
        logits_fake, fmap_fake = disc(out)
    loss_vals = {**wav_losses(batch, out, sample_rate),
                 **gan_losses(fmap_real, logits_fake, fmap_fake, dp)}
    grads = {name: torch.autograd.grad(loss_vals[name], out, share, retain_graph=True)[0]
             for name in LOSSES}
    out_grad, _ = balancer(grads, dp)
    torch.autograd.backward([output, loss_w], [out_grad, share])

    ld = output.new_zeros(())
    if train_disc:
        logits_fake_d, _ = disc(output.detach())
        ld = disc_loss(logits_real, logits_fake_d)
        ld.backward(share)
    norm = torch.linalg.vector_norm(out_grad)
    return {'loss_w': loss_w.detach(), 'loss_disc': ld.detach(),
            'balanced_grad_norm': norm if dp is None else torch.square(norm),
            **{k: v.detach() for k, v in loss_vals.items()}}


def _init_adam_state(opt: torch.optim.Adam) -> None:
    """Adam's zero state (step 0, zero moments) for every parameter that has
    none yet: the state torch creates at a parameter's first step and optax's
    ``init`` holds from the start, made ahead so that the guard can revert it
    in place. Laid out as torch's own (the step count on the parameter's
    device when ``capturable``, else a CPU scalar)."""
    for group in opt.param_groups:
        for p in group['params']:
            state = opt.state[p]
            if not state:
                on_device = group['capturable'] or group['fused']
                state['step'] = torch.zeros((), dtype=torch.float32,
                                            device=p.device if on_device else 'cpu')
                state['exp_avg'] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state['exp_avg_sq'] = torch.zeros_like(p, memory_format=torch.preserve_format)


def _guarded_tensors(model: EncodecModel, disc: MultiScaleSTFTDiscriminator,
                     opts: Sequence[torch.optim.Adam]) -> List[torch.Tensor]:
    """What a step updates in place and the guard may revert: the parameters,
    Adam's state and the codebook buffers (but the ``inited`` flags of stages
    known to be inited, which a step does not write)."""
    tensors = [p.data for m in (model, disc) for p in m.parameters()]
    for opt in opts:
        for group in opt.param_groups:
            for p in group['params']:
                state = opt.state[p]
                if state['step'].device != p.device:
                    raise ValueError('skip_nonfinite on CUDA needs Adam with its step count on '
                                     'the card: make_optimizer(..., capturable=True)')
                tensors += [state['step'], state['exp_avg'], state['exp_avg_sq']]
    vq = model.quantizer.vq
    for k, st in enumerate(vq.states()):
        tensors += [t for t in st if t is not st.inited or not vq.known_inited(k)]
    return tensors


def _all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool on the device: no NaN or Inf in any of ``tensors``. Each is
    multiplied by 0 (finite → 0, NaN and ±Inf → NaN) and summed, in fused
    multi-tensor launches; nothing can overflow."""
    sums = torch._foreach_norm(torch._foreach_mul(list(tensors), 0.0), 1)
    return torch.isfinite(torch.stack(sums)).all()


class NonFiniteGuard:
    """The guard around one step: made before it, it copies on the device
    what the step may change (:func:`_guarded_tensors`, and the balancer's
    EMA, which a step replaces); :meth:`apply` after it keeps the new state if
    every loss and every updated parameter and codebook buffer is finite, and
    puts the copies back otherwise. Nothing is read on the host."""

    def __init__(self, model: EncodecModel, disc: MultiScaleSTFTDiscriminator,
                 balancer: Balancer, opt_g: torch.optim.Adam, opt_d: torch.optim.Adam,
                 device: torch.device):
        _init_adam_state(opt_g)
        _init_adam_state(opt_d)
        for k in balancer.weights:
            balancer.total.setdefault(k, torch.zeros((), device=device))
            balancer.fix.setdefault(k, torch.zeros((), device=device))
        self.model, self.disc, self.balancer = model, disc, balancer
        self.tensors = _guarded_tensors(model, disc, (opt_g, opt_d))
        self.saved = [torch.empty_like(t) for t in self.tensors]
        torch._foreach_copy_(self.saved, self.tensors)
        self.saved_balancer = (dict(balancer.total), dict(balancer.fix))

    def apply(self, metrics: Dict[str, torch.Tensor],
              dp: Optional[DataParallel] = None) -> None:
        """Keep or revert the step; sets ``metrics['skipped_nonfinite']``.
        Under ``dp`` the step is kept only if it is finite on every rank."""
        ok = _all_finite([metrics['loss_g'], metrics['loss_w'], metrics['loss_disc'],
                          *self.model.parameters(), *self.disc.parameters(),
                          *(t for st in self.model.quantizer.vq.states() for t in st)])
        if dp is not None:
            ok = dp.all_(ok)
        with torch.no_grad():
            for t, s in zip(self.tensors, self.saved):
                torch.where(ok, t, s, out=t)
        for store, old in zip((self.balancer.total, self.balancer.fix), self.saved_balancer):
            for k, v in old.items():
                store[k] = torch.where(ok, store[k], v)
        metrics['skipped_nonfinite'] = (~ok).float()


def train_step(model: EncodecModel, disc: MultiScaleSTFTDiscriminator, balancer: Balancer,
               opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer,
               batch: torch.Tensor, *, n_q: int, train_disc: bool, lr_g: float, lr_d: float,
               sample_rate: int, generator: Optional[torch.Generator] = None,
               draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
               grad_accum_steps: int = 1, skip_nonfinite: bool = False,
               dp: Optional[DataParallel] = None) -> Dict[str, torch.Tensor]:
    """One step on ``batch [B, C, T]`` (under ``dp``, this rank's rows of
    the global batch); updates the modules, the optimizers and the balancer
    in place. Returns 0-d tensor metrics (no host sync; under ``dp`` the
    global batch's). ``grad_accum_steps`` must divide B."""
    N = int(grad_accum_steps)
    if N < 1 or batch.shape[0] % N:
        raise ValueError(f'batch size {batch.shape[0]} must divide grad_accum_steps={N}')
    guard = NonFiniteGuard(model, disc, balancer, opt_g, opt_d,
                           batch.device) if skip_nonfinite else None

    opt_g.zero_grad(set_to_none=True)
    opt_d.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    squares: List[torch.Tensor] = []       # under dp: each microbatch's cotangent norm²
    for a in range(N):
        mb = batch if N == 1 else batch[a::N].contiguous()
        mets = _microbatch(model, disc, balancer, mb, n_q, train_disc, sample_rate, generator,
                           draws, dp)
        if dp is not None:
            squares.append(mets.pop('balanced_grad_norm'))
        sums = {k: sums[k] + v for k, v in mets.items()} if sums else mets
    if dp is not None:
        keys = sorted(sums)
        total = dp.sum_(torch.stack([sums[k] for k in keys] + squares))
        sums = dict(zip(keys, total[:len(keys)] / dp.world),
                    balanced_grad_norm=torch.sqrt(total[len(keys):]).sum())
        for opt in (opt_g, opt_d):
            dp.sum_flat_([p.grad for g in opt.param_groups for p in g['params']
                          if p.grad is not None])
    avg = sums if N == 1 else {k: v / N for k, v in sums.items()}
    if N > 1:
        for opt in (opt_g, opt_d):
            grads = [p.grad for g in opt.param_groups for p in g['params'] if p.grad is not None]
            if grads:
                torch._foreach_mul_(grads, 1.0 / N)

    _set_lr(opt_g, lr_g)
    opt_g.step()
    if train_disc:
        _set_lr(opt_d, lr_d)
        opt_d.step()

    cluster_size = torch.stack([s.cluster_size for s in model.quantizer.vq.states()])
    metrics = {
        'loss_g': sum(balancer.weights[k] * avg[k] for k in LOSSES),
        'disc_updated': torch.tensor(float(train_disc)),
        'lr_g': torch.tensor(lr_g),
        'lr_d': torch.tensor(lr_d),
        **avg,
        **codebook_metrics(cluster_size, float(model.quantizer.threshold_ema_dead_code)),
    }
    if guard is not None:
        guard.apply(metrics, dp)
    return metrics


@torch.no_grad()
def eval_step(model: EncodecModel, disc: MultiScaleSTFTDiscriminator, batch: torch.Tensor,
              sample_rate: int) -> Dict[str, torch.Tensor]:
    """The test loop's step (``build_eval_step`` of the JAX package): the
    eval forward (``encode`` then ``decode``, cut to the input length), the
    discriminator on the real and the reconstructed batch, the generator's
    losses ``l_t``, ``l_f``, ``l_g``, ``l_feat`` and ``loss_disc``; nothing
    is updated. The caller puts the modules in eval mode."""
    output = model(batch)
    logits_real, fmap_real = disc(batch)
    logits_fake, fmap_fake = disc(output)
    return {**wav_losses(batch, output, sample_rate),
            **gan_losses(fmap_real, logits_fake, fmap_fake),
            'loss_disc': disc_loss(logits_real, logits_fake)}
