"""Training config: the defaults as a Python dict, plus ``key.path=value``
overrides.

Port of ``encodec_pytorch_tpu/config.py``. The machine with the card has no
pyyaml, so the defaults that the trainer reads are held here as four named
sets, copied from the JAX package's yaml files (same groups, keys and values):
``config`` from ``encodec_pytorch_tpu/configs/config.yaml`` (24 kHz mono, a
CSV dataset), ``config_48k_stereo`` from ``configs/config_48k_stereo.yaml``
(48 kHz stereo: non-causal, ``time_group_norm``, normalized 1 s segments,
batch 32 × 48000), ``config_mono_nq2`` from ``configs/config_mono_nq2.yaml``
(the multi-channel scene dataset under ``datasets.data_root``: 1 s mono
windows, batch 16 × 24000, ``fixed_length`` 27600 items an epoch; ``model.n_q``
2, a discriminator update on half the steps, f32) and
``config_mono_nq2_resume`` from ``configs/config_mono_nq2_resume.yaml`` (the
same, resuming from ``checkpoint.checkpoint_path``;
``checkpoint.disc_checkpoint_path`` is accepted and unused, as in the JAX
trainer: the one file holds both models). Override values are parsed without
yaml: ``true``/``false``, ``none``/``null``, numbers (``3e-4``, ``24_000``),
Python literals (``[1024, 512]``), else the string itself; then ``${a.b}``
references are resolved, as the JAX package resolves them (the checkpoint
``save_location`` template).

``tpu.compute_dtype`` is the yaml's: ``bfloat16`` in ``config`` (the JAX
package's default, ``configs/config.yaml:71``: bf16 activations, f32 master
weights, f32 in the LSTM, the quantizer and the losses; ``float32`` by
override) and ``float32`` in the others. ``tpu.grad_accum_steps``
(``config.yaml:104-111``) and ``tpu.skip_nonfinite_steps`` (``:112-117``) are
the yaml's too. The default that differs from the yamls: ``tpu.disc_pallas_v2``
is True in every set (the discriminator's eligible convs go through the CUDA
kernel K4; False takes ``F.conv2d``). The key ``tpu.disc_im2col`` is the
port's own: True puts the forward of the discriminator's F-stride-2 convs on
the CUDA kernel K5 (the im2col GEMM of
``encodec_pytorch_tpu/ops/pallas_conv2d.py``), False leaves them to K4 or
``F.conv2d``. It selects between two implementations of the same conv; the
JAX yaml has no such key because the JAX package wires that kernel nowhere.
It is True in ``config_48k_stereo`` only. Keys of the yaml that the port does
not read are left out.

``distributed`` (``config.yaml:56-61``): ``data_parallel`` and ``world_size``
(0: as many processes as the launcher started) are checked against the
launcher (``train.trainer.check_supported``); ``init_method`` is ``env``
(torchrun's environment; the yaml's ``jax`` names the JAX package's
initialisation) or a ``file://``/``tcp://`` URL. ``find_unused_parameters``
and ``torch_distributed_debug`` are accepted and read by nothing, as in the
JAX package: the step has no ``DistributedDataParallel`` wrapper (every rank
computes gradients for the same parameters and sums them in one flat
all-reduce), and torch reads ``TORCH_DISTRIBUTED_DEBUG`` from the
environment itself.
"""

import ast
import copy
from fractions import Fraction
from typing import Any, Dict, Optional, Sequence

_SAVE_LOCATION = ('${checkpoint.save_folder}/bs${datasets.batch_size}_cut${datasets.tensor_cut}'
                  '_length${datasets.fixed_length}_')

DEFAULTS: Dict[str, Any] = {
    'common': {'save_interval': 2, 'test_interval': 5, 'log_interval': 100, 'max_epoch': 100,
               'seed': 3401},
    'datasets': {'train_csv_path': './datasets/train.csv',
                 'test_csv_path': './datasets/test.csv', 'dataset': 'csv', 'data_root': '',
                 'batch_size': 12,
                 'tensor_cut': 72000, 'fixed_length': 0},
    'checkpoint': {'resume': False, 'checkpoint_path': '', 'save_folder': './checkpoints/',
                   'save_location': _SAVE_LOCATION},
    'optimization': {'lr': 3e-4, 'disc_lr': 3e-4},
    'lr_scheduler': {'warmup_epoch': 5},
    'model': {'target_bandwidths': [1.5, 3., 6., 12., 24.], 'sample_rate': 24_000,
              'channels': 1, 'train_discriminator': True, 'audio_normalize': True,
              'filters': 32, 'ratios': [8, 5, 4, 2],
              'disc_win_lengths': [1024, 2048, 512], 'disc_hop_lengths': [256, 512, 128],
              'disc_n_ffts': [1024, 2048, 512], 'causal': True, 'norm': 'weight_norm',
              'segment': None, 'name': 'my_encodec'},
    'distributed': {'data_parallel': True, 'world_size': 0, 'find_unused_parameters': False,
                    'torch_distributed_debug': False, 'init_method': 'env'},
    'balancer': {'weights': {'l_t': 0.1, 'l_f': 1, 'l_g': 3, 'l_feat': 3}},
    'tpu': {'compute_dtype': 'bfloat16', 'disc_pallas_v2': True, 'disc_im2col': False,
            'grad_accum_steps': 1, 'skip_nonfinite_steps': False, 'async_checkpoint': True},
}

DEFAULTS_48K_STEREO: Dict[str, Any] = {
    'common': {'save_interval': 2, 'test_interval': 5, 'log_interval': 100, 'max_epoch': 100,
               'seed': 3401},
    'datasets': {'train_csv_path': './datasets/train_48k.csv',
                 'test_csv_path': './datasets/test_48k.csv', 'dataset': 'csv', 'data_root': '',
                 'batch_size': 32,
                 'tensor_cut': 48000, 'fixed_length': 0},
    'checkpoint': {'resume': False, 'checkpoint_path': '', 'save_folder': './checkpoints_48k/',
                   'save_location': _SAVE_LOCATION},
    'optimization': {'lr': 3e-4, 'disc_lr': 3e-4},
    'lr_scheduler': {'warmup_epoch': 5},
    'model': {'target_bandwidths': [3., 6., 12., 24.], 'sample_rate': 48_000,
              'channels': 2, 'train_discriminator': True, 'audio_normalize': True,
              'filters': 32, 'ratios': [8, 5, 4, 2],
              'disc_win_lengths': [1024, 2048, 512], 'disc_hop_lengths': [256, 512, 128],
              'disc_n_ffts': [1024, 2048, 512], 'causal': False, 'norm': 'time_group_norm',
              'segment': 1.0, 'name': 'encodec_48khz'},
    'distributed': {'data_parallel': True, 'world_size': 0, 'find_unused_parameters': False,
                    'torch_distributed_debug': False, 'init_method': 'env'},
    'balancer': {'weights': {'l_t': 0.1, 'l_f': 1, 'l_g': 4, 'l_feat': 4}},
    'tpu': {'compute_dtype': 'float32', 'disc_pallas_v2': True, 'disc_im2col': True,
            'async_checkpoint': True},
}

DEFAULTS_MONO_NQ2: Dict[str, Any] = {
    'common': {'save_interval': 2, 'test_interval': 5, 'log_interval': 100, 'max_epoch': 300,
               'seed': 3401},
    'datasets': {'dataset': 'multi_channel', 'data_root': '/scratch/eigenscape',
                 'train_csv_path': '', 'test_csv_path': '', 'batch_size': 16,
                 'tensor_cut': 24000, 'fixed_length': 27600},
    'checkpoint': {'resume': False, 'checkpoint_path': '', 'disc_checkpoint_path': '',
                   'save_folder': './checkpoints_mono_nq2/', 'save_location': _SAVE_LOCATION},
    'optimization': {'lr': 3e-4, 'disc_lr': 3e-4},
    'lr_scheduler': {'warmup_epoch': 5},
    'model': {'target_bandwidths': [1.5, 3., 6., 12., 24.], 'sample_rate': 24_000,
              'channels': 1, 'train_discriminator': 0.5, 'audio_normalize': True,
              'filters': 32, 'ratios': [8, 5, 4, 2],
              'disc_win_lengths': [1024, 2048, 512], 'disc_hop_lengths': [256, 512, 128],
              'disc_n_ffts': [1024, 2048, 512], 'causal': True, 'norm': 'weight_norm',
              'segment': None, 'name': 'my_encodec', 'n_q': 2},
    'distributed': {'data_parallel': False, 'world_size': 1, 'find_unused_parameters': False,
                    'torch_distributed_debug': False, 'init_method': 'env'},
    'balancer': {'weights': {'l_t': 0.1, 'l_f': 1, 'l_g': 3, 'l_feat': 3}},
    'wandb': {'enabled': False},
    'tpu': {'compute_dtype': 'float32', 'disc_pallas_v2': True, 'disc_im2col': False,
            'async_checkpoint': True},
}

_RESUME = './checkpoints_mono_nq2/bs16_cut24000_length27600_epoch74'
DEFAULTS_MONO_NQ2_RESUME: Dict[str, Any] = copy.deepcopy(DEFAULTS_MONO_NQ2)
DEFAULTS_MONO_NQ2_RESUME['checkpoint'].update(
    resume=True, checkpoint_path=f'{_RESUME}_lr0.0003.ckpt',
    disc_checkpoint_path=f'{_RESUME}_disc_lr0.0003.ckpt')

CONFIGS: Dict[str, Dict[str, Any]] = {'config': DEFAULTS,
                                      'config_48k_stereo': DEFAULTS_48K_STEREO,
                                      'config_mono_nq2': DEFAULTS_MONO_NQ2,
                                      'config_mono_nq2_resume': DEFAULTS_MONO_NQ2_RESUME}


class Config:
    """Attribute access over nested dicts (``config.model.sample_rate``)."""

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, '_data', data)

    def __getattr__(self, name):
        try:
            value = self._data[name]
        except KeyError:
            raise AttributeError(name) from None
        return Config(value) if isinstance(value, dict) else value

    def get(self, name, default=None):
        value = self._data.get(name, default)
        return Config(value) if isinstance(value, dict) else value

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)


def parse_value(text: str) -> Any:
    """An override's value, parsed as the yaml loader would for the values
    this config holds."""
    low = text.strip().lower()
    if low in ('true', 'false'):
        return low == 'true'
    if low in ('none', 'null', '~', ''):
        return None
    try:
        return ast.literal_eval(text.strip())
    except (ValueError, SyntaxError):
        return text.strip()


def load_config(overrides: Optional[Sequence[str]] = None, name: str = 'config') -> Config:
    """The default set ``name`` (a key of :data:`CONFIGS`) with
    ``key.path=value`` overrides."""
    if name not in CONFIGS:
        raise ValueError(f'unknown config {name!r}; the port has {sorted(CONFIGS)}')
    data = copy.deepcopy(CONFIGS[name])
    for ov in overrides or []:
        if '=' not in ov:
            raise ValueError(f'override must be key.path=value, got {ov!r}')
        key, _, val = ov.partition('=')
        node = data
        *parents, leaf = key.strip().split('.')
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f'cannot override through non-dict at {p} in {key}')
        node[leaf] = parse_value(val)
    _interpolate(data)
    return Config(data)


def _interpolate(data: Dict[str, Any]) -> None:
    """Resolve ``${a.b}`` references in string values, in place (the
    checkpoint ``save_location`` template)."""
    def lookup(dotted: str) -> Any:
        node = data
        for part in dotted.split('.'):
            node = node[part]
        return resolve(node)

    def resolve(value: Any) -> Any:
        if not isinstance(value, str) or '${' not in value:
            return value
        out, rest = '', value
        while '${' in rest:
            pre, _, tail = rest.partition('${')
            ref, _, rest = tail.partition('}')
            out += pre + str(lookup(ref))
        return out + rest

    def walk(node: Dict[str, Any]) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value)
            else:
                node[key] = resolve(value)
    walk(data)


def parse_segment(value: Any) -> Optional[float]:
    """'None'/None → None; a number or numeric string → float."""
    if value is None or (isinstance(value, str) and value.strip().lower() in
                         ('none', 'null', '')):
        return None
    return float(value)


def parse_probability(value: Any) -> float:
    """train_discriminator: True → 1.0, False → 0.0, a number, or "2/3"."""
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        return float(Fraction(value))
    raise ValueError(f'cannot parse probability from {value!r}')
