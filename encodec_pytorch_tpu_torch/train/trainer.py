"""The training loop: model, discriminator, balancer, schedules and Adam
built from the config; ``run`` tests, then trains ``common.max_epoch``
epochs, testing every ``common.test_interval`` and saving every
``common.save_interval`` epochs.

Port of ``encodec_pytorch_tpu/train/trainer.py`` for every default set
(``config``: 24 kHz mono; ``config_48k_stereo``: 48 kHz stereo, segmented,
normalized, ``time_group_norm``; ``config_mono_nq2``: 24 kHz mono at n_q 2 on
1 s windows of the multi-channel scene dataset, selected by
``datasets.dataset``), on one card or data-parallel over several, one process
a card: ``torchrun --nproc_per_node N -m encodec_pytorch_tpu_torch.train_cli``
(``parallel/mesh.py``; ``--device cuda`` is then ``cuda:LOCAL_RANK``, NCCL on
the cards, gloo with ``--device cpu``). Each rank loads its shard of both sets
(``datasets.batch_size`` is the global batch, ``batch_size / N`` rows a rank)
and the step computes the global batch's update on every rank
(``train/step.py``). A config the launcher contradicts is refused before
anything starts (:func:`check_supported`). Only rank 0 writes checkpoints,
tensorboard and the reconstruction demo, and logs the training lines; every
rank runs its test shard, and rank 0 reports its own shard's mean, as the JAX
trainer does; every rank loads the resume checkpoint. Each process logs to
``{save_folder}/train_encodec_bs{batch}_lr{lr}.log``, rank r > 0 to
``..._p{r}.log``. The step runs in
``tpu.compute_dtype`` (``bfloat16`` in ``config``, as the JAX yaml has it:
bf16 activations, f32 master weights, f32 in the LSTM, the quantizer and the
losses; ``float32`` in the other sets), accumulates gradients over
``tpu.grad_accum_steps`` microbatches, and with ``tpu.skip_nonfinite_steps``
drops a step whose losses or updated state are not finite (logged as the
JAX trainer logs it). Losses go to tensorboard (``tensorboardX``, under
``{save_folder}/runs``, the JAX trainer's scalar names) where it imports, and
otherwise the run logs the JAX trainer's warning and goes on; wandb is never
written (``wandb.enabled`` logs a warning).

State (``checkpoint.py``): one file holds the generator (in the reference
trainer's layout, ``model_state_dict`` with the quantizer under
``quantizer.model``, so ``my_encodec_model`` loads it), the discriminator,
both Adam states, the balancer's EMA, both random generators' states, and
the epoch and step. ``checkpoint.resume`` restores all of it from
``checkpoint.checkpoint_path``; a file written mid-epoch (its step past its
epoch's last) makes the first resumed epoch skip the batches the cut run
consumed, so that the resumed run takes the uncut run's trajectory.

SIGTERM (preemption): the handler only records the signal, because Python
runs it between any two bytecodes, which can be inside a step between the
generator's and the discriminator's update; the loop then writes
``epoch{completed}_preempt_lr{lr}.ckpt`` at the next step boundary (it never
overwrites the epoch-boundary file), waits for it to land and exits with
128 + the signal's number. Under data parallelism the ranks take the largest
signal number over all of them at each step boundary (a max all-reduce), so
all stop after the same step even when one rank alone got the signal; rank 0
writes the file, and no rank exits before it has landed.

Randomness: weights are drawn from ``common.seed``; the step's bandwidth and
discriminator coin from a host generator (seed + 1); the RVQ's k-means and
expiry draws from a generator on the device (seed + 2). Every rank seeds them
alike, so every rank draws the same.
"""

import logging
import os
import signal
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from ..config import Config, parse_probability, parse_segment
from ..data import CustomAudioDataset, DataLoader, MultiChannelAudioDataset
from ..models.model import EncodecModel, from_trainer_layout, to_trainer_layout
from ..models.msstftd import MultiScaleSTFTDiscriminator
from ..ops import conv
from ..parallel.mesh import (DataParallel, initialize_distributed, launcher_world_size,
                             local_device)
from ..utils import save_audio
from .balancer import Balancer
from .checkpoint import CheckpointWriter, load_checkpoint
from .schedule import warmup_cosine_schedule
from .step import eval_step, make_optimizer, train_step

logger = logging.getLogger('encodec_pytorch_tpu_torch')

Device = Union[str, torch.device]

# the JAX trainer's tensorboard scalars of a training log line, beside Loss_G,
# Loss_W and Loss_Disc (encodec_pytorch_tpu/train/trainer.py:405-420)
TRAIN_SCALARS = ('skipped_nonfinite', 'l_t', 'l_f', 'l_g', 'l_feat', 'codebook_entropy',
                 'codebook_dead_frac')


def open_tensorboard(save_folder: str):
    """A ``tensorboardX`` writer under ``{save_folder}/runs``, or None, with
    the JAX trainer's warning, where it cannot be opened."""
    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(log_dir=os.path.join(save_folder, 'runs'))
    except (ImportError, OSError) as exc:
        logger.warning('tensorboard unavailable: %s', exc)
        return None
    logger.info('Saving tensorboard logs to %s', Path(writer.logdir).resolve())
    return writer


DATASETS = {'csv': CustomAudioDataset, 'multi_channel': MultiChannelAudioDataset}


def check_supported(config: Config, world: Optional[int] = None) -> None:
    """Raise on a config option that the port does not run, or that the
    launcher contradicts (``world``: the run's process count,
    :func:`~..parallel.mesh.launcher_world_size` by default):
    ``distributed.data_parallel`` False under more than one process, a
    ``distributed.world_size`` above 0 that is not the process count, or a
    batch that does not divide over the processes and then over
    ``tpu.grad_accum_steps`` (the JAX trainer's checks)."""
    compute_dtype(config)
    dataset = str(config.datasets.get('dataset', 'csv'))
    if dataset not in DATASETS:
        raise NotImplementedError(
            f"datasets.dataset={dataset} is not ported yet; the port runs {sorted(DATASETS)}")
    world = launcher_world_size() if world is None else int(world)
    dist = config.get('distributed', Config({}))
    if not bool(dist.get('data_parallel', False)):
        if world > 1:
            raise ValueError(f'distributed.data_parallel is False, but the launcher started '
                             f'{world} processes')
    elif int(dist.get('world_size', 0) or 0) not in (0, world):
        raise ValueError(f'distributed.world_size={dist.world_size}, but the launcher started '
                         f'{world} process(es) (WORLD_SIZE); 0 takes them all')
    batch = int(config.datasets.batch_size)
    accum = int(config.get('tpu', Config({})).get('grad_accum_steps', 1))
    if batch % world or (batch // world) % accum:
        raise ValueError(f'batch_size {batch} must divide over {world} process(es) and then '
                         f'tpu.grad_accum_steps={accum}')


def compute_dtype(config: Config) -> torch.dtype:
    """``tpu.compute_dtype`` (float32 when absent) as a torch dtype."""
    return conv.compute_dtype(str(config.get('tpu', Config({})).get('compute_dtype', 'float32')))


def build_dataset(config: Config, mode: str):
    """The ``datasets.dataset`` set (``csv`` when absent) for ``mode``
    ('train' or 'test'), its draws keyed by ``common.seed``."""
    kind = DATASETS[str(config.datasets.get('dataset', 'csv'))]
    return kind(config, mode=mode, seed=config.common.seed)


def build_model_from_config(config: Config, device: Device = 'cuda',
                            generator: Optional[torch.Generator] = None) -> EncodecModel:
    """The generator, as the JAX package's factory builds it, in the
    config's compute dtype, on ``device``."""
    m = config.model
    n_q = m.get('n_q', None)
    model = EncodecModel._get_model(
        list(m.target_bandwidths), int(m.sample_rate), int(m.channels), causal=bool(m.causal),
        model_norm=str(m.norm), audio_normalize=bool(m.audio_normalize),
        segment=parse_segment(m.segment), name=str(m.name), ratios=list(m.ratios),
        n_q=int(n_q) if n_q else None, n_filters=int(m.get('n_filters', 32)),
        generator=generator, dtype=compute_dtype(config))
    return model.to(device)


def build_disc_from_config(config: Config, device: Device = 'cuda',
                           generator: Optional[torch.Generator] = None
                           ) -> MultiScaleSTFTDiscriminator:
    """The discriminator, with ``in_channels = out_channels`` = the audio's
    channels, in the config's compute dtype; ``tpu.disc_im2col`` puts the
    forward of its F-stride-2 convs on kernel K5, and ``tpu.disc_pallas_v2``
    routes its other eligible convs (and every eligible conv's input gradient)
    to kernel K4."""
    m = config.model
    tpu = config.get('tpu', Config({}))
    disc = MultiScaleSTFTDiscriminator(
        filters=int(m.filters), in_channels=int(m.channels), out_channels=int(m.channels),
        n_ffts=tuple(m.disc_n_ffts), hop_lengths=tuple(m.disc_hop_lengths),
        win_lengths=tuple(m.disc_win_lengths),
        disc_kernel=bool(tpu.get('disc_pallas_v2', True)),
        disc_im2col=bool(tpu.get('disc_im2col', False)), generator=generator,
        dtype=compute_dtype(config))
    return disc.to(device)


def setup_logging(save_folder: str, tag: str) -> None:
    """This process's log file, ``{save_folder}/train_encodec_{tag}.log``,
    with the reference's format, in place of any earlier one (the JAX
    trainer's ``setup_logging``; the console is the caller's)."""
    for handler in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        logger.removeHandler(handler)
        handler.close()
    os.makedirs(save_folder, exist_ok=True)
    handler = logging.FileHandler(os.path.join(save_folder, f'train_encodec_{tag}.log'))
    handler.setFormatter(logging.Formatter(
        '%(asctime)s: %(levelname)s: [%(filename)s: %(lineno)d]: %(message)s'))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)


class Trainer:
    def __init__(self, config: Config, device: Device = 'cuda'):
        check_supported(config)
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('no CUDA device; pass device="cpu" to train on the CPU')
        dist_cfg = config.get('distributed', Config({}))
        self.dp: Optional[DataParallel] = None
        if bool(dist_cfg.get('data_parallel', False)):
            self.dp = initialize_distributed(local_device(device),
                                             str(dist_cfg.get('init_method', 'env')))
        self.device = local_device(device) if self.dp else device
        self.rank, self.world = (self.dp.rank, self.dp.world) if self.dp else (0, 1)
        self.is_main = self.rank == 0
        tag = f'bs{config.datasets.batch_size}_lr{config.optimization.lr}'
        setup_logging(str(config.checkpoint.save_folder),
                      tag if self.is_main else f'{tag}_p{self.rank}')
        if self.device.type == 'cuda':
            # f32 means f32: cuDNN would otherwise run the f32 convs in TF32,
            # and cuBLAS may reduce bf16 products at reduced precision
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.config = config
        tpu = config.get('tpu', Config({}))
        self.grad_accum_steps = int(tpu.get('grad_accum_steps', 1))
        self.skip_nonfinite = bool(tpu.get('skip_nonfinite_steps', False))
        seed = int(config.common.seed or 0)
        init = torch.Generator().manual_seed(seed)
        self.model = build_model_from_config(config, self.device, init).train()
        self.disc = build_disc_from_config(config, self.device, init).train()
        self.balancer = Balancer(config.balancer.weights.to_dict())
        # the guard reverts Adam's step counts on the card: capturable keeps them there
        capturable = self.skip_nonfinite and self.device.type == 'cuda'
        self.opt_g = make_optimizer(self.model.parameters(), capturable)
        self.opt_d = make_optimizer(self.disc.parameters(), capturable)
        self.host_gen = torch.Generator().manual_seed(seed + 1)
        self.device_gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        self.train_step = train_step
        self.writer = CheckpointWriter()
        self.tb = None      # the tensorboard writer, open inside run()
        self.data_ms: List[float] = []      # the last epoch's loader ms a batch
        if bool(config.get('wandb', Config({})).get('enabled', False)):
            logger.warning('wandb unavailable: the port does not log to wandb')

        self.tensor_cut = int(config.datasets.tensor_cut)
        local_batch = int(config.datasets.batch_size) // self.world
        self.trainset = build_dataset(config, 'train')
        self.testset = build_dataset(config, 'test')
        shard = dict(fixed_length=self.tensor_cut, seed=seed, shard_id=self.rank,
                     num_shards=self.world)
        self.trainloader = DataLoader(self.trainset, local_batch, **shard)
        self.testloader = DataLoader(self.testset, local_batch, shuffle=False, **shard)
        steps_per_epoch = max(1, len(self.trainloader))
        max_iter = int(config.common.max_epoch) * steps_per_epoch
        warmup_iter = int(config.lr_scheduler.warmup_epoch) * steps_per_epoch
        self.gen_schedule = warmup_cosine_schedule(
            float(config.optimization.lr), max_iter=max_iter, eta_ratio=0.1,
            warmup_iter=warmup_iter, warmup_ratio=1e-4)
        self.disc_schedule = warmup_cosine_schedule(
            float(config.optimization.disc_lr), max_iter=max_iter, eta_ratio=0.1,
            warmup_iter=warmup_iter, warmup_ratio=1e-4)
        self.warmup_epoch = int(config.lr_scheduler.warmup_epoch)
        self.disc_prob = parse_probability(config.model.train_discriminator)
        self.n_q_table = self.model.n_q_for_bandwidth_index()
        self.step = 0
        self.history: List[Dict[str, Any]] = []
        self.test_history: List[Dict[str, float]] = []
        self._signum: Optional[int] = None

        self.resume_epoch = 0
        self._resume_skip = (0, 0)      # (epoch to skip batches in, batches to skip)
        if bool(config.checkpoint.get('resume', False)):
            path = str(config.checkpoint.get('checkpoint_path', '') or '')
            if not path:
                raise ValueError('checkpoint.resume needs checkpoint.checkpoint_path')
            state, self.resume_epoch = load_checkpoint(path)
            if self.resume_epoch >= int(config.common.max_epoch):
                raise ValueError(f'resume epoch {self.resume_epoch} is not below the '
                                 f'{config.common.max_epoch} epochs of the run')
            self.load_state_dict(state)
            done_in_epoch = self.step - self.resume_epoch * steps_per_epoch
            if done_in_epoch > 0:
                self._resume_skip = (self.resume_epoch + 1, min(done_in_epoch, steps_per_epoch))
                logger.info('mid-epoch checkpoint: epoch %d already consumed %d/%d batches; '
                            'they are skipped', *self._resume_skip, steps_per_epoch)
            logger.info('loaded checkpoint %s (step %d), resume from epoch %d', path,
                        self.step, self.resume_epoch)
        logger.info('rank %d of %d, device %s; %d batches an epoch, %d test batches (of this '
                    'rank\'s shard); generator %d parameters, discriminator %d; compute dtype '
                    '%s, %d microbatch(es) a step, non-finite guard %s', self.rank, self.world,
                    self.device, len(self.trainloader),
                    len(self.testloader), sum(p.numel() for p in self.model.parameters()),
                    sum(p.numel() for p in self.disc.parameters()), compute_dtype(config),
                    self.grad_accum_steps, 'on' if self.skip_nonfinite else 'off')

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def state_dict(self) -> Dict[str, Any]:
        """The whole training state, as live references (the checkpoint
        writer copies it). The generator is in the reference trainer's
        layout (quantizer under ``quantizer.model``)."""
        return {
            'model_state_dict': to_trainer_layout(self.model.state_dict()),
            'disc_state_dict': self.disc.state_dict(),
            'optimizer_g': self.opt_g.state_dict(),
            'optimizer_d': self.opt_d.state_dict(),
            'balancer': {'total': dict(self.balancer.total), 'fix': dict(self.balancer.fix)},
            'host_generator': self.host_gen.get_state(),
            'device_generator': self.device_gen.get_state(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore what :meth:`state_dict` gave, and ``step``, in place:
        parameters and buffers are copied into the live tensors (so every
        cache keyed on their versions, K3's weights and the quantizer's
        tables, sees the change)."""
        self.model.load_state_dict(from_trainer_layout(state['model_state_dict']), strict=True)
        self.disc.load_state_dict(state['disc_state_dict'], strict=True)
        self.opt_g.load_state_dict(state['optimizer_g'])
        self.opt_d.load_state_dict(state['optimizer_d'])
        for name in ('total', 'fix'):
            setattr(self.balancer, name, {k: v.to(self.device)
                                          for k, v in state['balancer'][name].items()})
        self.host_gen.set_state(state['host_generator'])
        self.device_gen.set_state(state['device_generator'])
        self.step = int(state['step'])

    def close(self) -> None:
        """Release the process group if this trainer started it."""
        if self.dp is not None:
            self.dp.close()

    def replicated_tensors(self) -> List[torch.Tensor]:
        """The state every rank holds alike: parameters, buffers, Adam's
        state and the balancer's EMA."""
        out = [t for m in (self.model, self.disc) for t in m.state_dict().values()]
        for opt in (self.opt_g, self.opt_d):
            out += [v for st in opt.state.values() for _, v in sorted(st.items())]
        return out + [d[k] for d in (self.balancer.total, self.balancer.fix) for k in sorted(d)]

    def save(self, epoch: int, suffix: str = '') -> Optional[str]:
        """Write the state to ``{save_location}epoch{epoch}{suffix}_lr{lr}.ckpt``,
        on a writer thread unless ``tpu.async_checkpoint`` is False; returns
        the path. Only rank 0 writes (the state is every rank's alike); the
        others return None."""
        if not self.is_main:
            return None
        cfg = self.config
        path = f'{cfg.checkpoint.save_location}epoch{epoch}{suffix}_lr{cfg.optimization.lr}.ckpt'
        async_write = bool(cfg.get('tpu', Config({})).get('async_checkpoint', True))
        if async_write:
            logger.info('checkpoint write scheduled: %s', path)
        self.writer.save(path, self.state_dict(), epoch, self.step, async_write=async_write,
                         on_written=lambda p: logger.info('saved checkpoint %s', p))
        return path

    def _preempt_point(self, completed_epochs: int) -> None:
        """At a step boundary: if SIGTERM came (to any rank), write the
        ``_preempt`` checkpoint, wait for it and exit with 128 + the signal."""
        signum = self._signum or 0
        if self.dp is not None:
            signum = int(self.dp.max_(torch.tensor([signum], device=self.dp.device))[0])
        if not signum:
            return
        logger.warning('signal %d: writing the preemption checkpoint at step %d',
                       signum, self.step)
        self.save(completed_epochs, suffix='_preempt')
        self.writer.wait_pending()
        if self.dp is not None:
            self.dp.barrier()       # no rank leaves before the file has landed
        raise SystemExit(128 + signum)

    def train_one_epoch(self, epoch: int) -> Dict[str, Any]:
        """One pass over the training set (less the batches a mid-epoch
        resume skips). Returns the epoch's mean metrics, ``steps`` and
        ``step_ms`` (host clock around each step, which ends in a device
        synchronize); keeps in ``data_ms`` the host clock around the loader's
        making of each batch (reads, resampling, crops)."""
        cfg = self.config
        self.trainloader.set_epoch(epoch)
        n = len(self.trainloader)
        disc_allowed = self.disc_prob > 0 and epoch >= self.warmup_epoch
        log_interval = int(cfg.common.log_interval)
        skip = self._resume_skip[1] if epoch == self._resume_skip[0] else 0
        if skip:
            logger.info('epoch %d: skipping %d already-consumed batches (mid-epoch resume)',
                        epoch, skip)
        acc: Dict[str, torch.Tensor] = {}
        step_ms: List[float] = []
        self.data_ms = []
        since_log = 0
        batches = iter(self.trainloader)
        for idx in range(n):
            t_data = time.perf_counter()
            batch_np = next(batches)
            if idx < skip:
                continue
            t0 = time.perf_counter()
            self.data_ms.append(1000 * (t0 - t_data))
            batch = torch.from_numpy(batch_np).to(self.device)
            bw_index = int(torch.randint(len(self.n_q_table), (1,), generator=self.host_gen))
            coin = float(torch.rand((), generator=self.host_gen)) < self.disc_prob
            metrics = self.train_step(
                self.model, self.disc, self.balancer, self.opt_g, self.opt_d, batch,
                n_q=self.n_q_table[bw_index], train_disc=disc_allowed and coin,
                lr_g=self.gen_schedule(self.step), lr_d=self.disc_schedule(self.step),
                sample_rate=int(cfg.model.sample_rate), generator=self.device_gen,
                grad_accum_steps=self.grad_accum_steps, skip_nonfinite=self.skip_nonfinite,
                dp=self.dp)
            self.step += 1
            self._sync()
            step_ms.append(1000 * (time.perf_counter() - t0))
            acc = {k: acc.get(k, 0) + v.detach().cpu() for k, v in metrics.items()}
            since_log += 1
            if self.is_main and (idx % log_interval == 0 or idx == n - 1):
                avg = {k: float(v) / len(step_ms) for k, v in acc.items()}
                logger.info('Epoch %d %d/%d\tAvg loss_G: %.4f\tAvg loss_W: %.4f\tlr_G: %.6e\t'
                            'lr_D: %.6e\tloss_disc: %.4f\t%.1f ms/step', epoch, idx + 1, n,
                            avg['loss_g'], avg['loss_w'], float(metrics['lr_g']),
                            float(metrics['lr_d']), avg['loss_disc'],
                            sum(step_ms[-since_log:]) / since_log)
                if avg.get('skipped_nonfinite', 0) > 0:
                    logger.warning('dropped %d non-finite step(s) in the last %d steps '
                                   '(tpu.skip_nonfinite_steps guard)',
                                   int(round(avg['skipped_nonfinite'] * len(step_ms))),
                                   len(step_ms))
                if self.tb is not None:
                    gstep = (epoch - 1) * n + idx
                    self.tb.add_scalar('Train/Loss_G', avg['loss_g'], gstep)
                    for k in TRAIN_SCALARS:
                        if k in avg:
                            self.tb.add_scalar(f'Train/{k}', avg[k], gstep)
                    self.tb.add_scalar('Train/Loss_W', avg['loss_w'], gstep)
                    self.tb.add_scalar('Train/Loss_Disc', avg['loss_disc'], gstep)
                since_log = 0
            self._preempt_point(epoch - 1)
        out: Dict[str, Any] = {k: float(v) / max(len(step_ms), 1) for k, v in acc.items()}
        out['steps'] = len(step_ms)
        out['step_ms'] = step_ms
        return out

    def test(self, epoch: int) -> Optional[Dict[str, float]]:
        """The test loop (eval mode, no gradients) over the test set: logs
        the ``| TEST |`` line and writes ``GT.wav`` and ``Reconstruction.wav``
        (a random uncropped test clip and its reconstruction) to
        ``checkpoint.save_folder``. Returns the mean losses and ``ms`` (host
        clock over the batches, ending in a synchronize), or None, with a
        warning, when the test set holds less than one batch."""
        cfg = self.config
        n = len(self.testloader)
        if n == 0:
            logger.warning('the test set holds %d clips, fewer than one batch of %d on each '
                           'of %d rank(s): no test batch at epoch %d', len(self.testset),
                           self.testloader.batch_size, self.world, epoch)
            return None
        sample_rate = int(cfg.model.sample_rate)
        self.model.eval()
        self.disc.eval()
        try:
            t0 = time.perf_counter()
            sums: Dict[str, torch.Tensor] = {}
            for batch_np in self.testloader:
                out = eval_step(self.model, self.disc, torch.from_numpy(batch_np).to(self.device),
                                sample_rate)
                sums = {k: sums.get(k, 0) + v for k, v in out.items()}
            avg = {k: float(v) / n for k, v in sums.items()}
            self._sync()
            avg['ms'] = 1000 * (time.perf_counter() - t0)
            self.test_history.append(dict(avg, epoch=epoch))
            if not self.is_main:
                return avg
            logger.info('| TEST | epoch: %d | loss_g: %.4f | loss_disc: %.4f', epoch,
                        sum(v for k, v in avg.items() if k not in ('loss_disc', 'ms')),
                        avg['loss_disc'])
            if self.tb is not None:
                for k, v in avg.items():
                    if k != 'ms':
                        self.tb.add_scalar(f'Test/{k}', v, epoch)
            wav, sr = self.testset.get()
            recon = self.model(torch.from_numpy(wav[None]).to(self.device))[0].cpu().numpy()
        finally:
            self.model.train()
            self.disc.train()
        folder = Path(str(cfg.checkpoint.save_folder))
        save_audio(wav, folder / 'GT.wav', sr)
        save_audio(recon, folder / 'Reconstruction.wav', sr)
        return avg

    def run(self) -> List[Dict[str, Any]]:
        """``test(0)``, then the epochs from the one after the resumed one to
        ``common.max_epoch``, each followed by its test and save at their
        intervals. Keeps each epoch's summary in ``history`` and returns it.
        SIGTERM ends the run at the next step boundary with a ``_preempt``
        checkpoint and ``SystemExit(128 + signal)``."""
        cfg = self.config

        def on_term(signum, frame):
            logger.warning('received signal %d: the preemption checkpoint is written at the '
                           'next step boundary', signum)
            self._signum = signum

        previous = signal.signal(signal.SIGTERM, on_term)
        self.tb = open_tensorboard(str(cfg.checkpoint.save_folder)) if self.is_main else None
        try:
            self.test(0)
            for epoch in range(self.resume_epoch + 1, int(cfg.common.max_epoch) + 1):
                self.history.append(self.train_one_epoch(epoch))
                if epoch % int(cfg.common.test_interval) == 0:
                    self.test(epoch)
                if epoch % int(cfg.common.save_interval) == 0:
                    self.save(epoch)
                self._preempt_point(epoch)
        finally:
            signal.signal(signal.SIGTERM, previous)
            self.writer.wait_pending()
            if self.tb is not None:
                self.tb.close()
                self.tb = None
        return self.history
