"""Weight bridge from the JAX package's variables to this package's state dict.

``state_dict_from_jax`` takes the JAX ``EncodecModel`` variables tree with
every leaf already a numpy array (``jax.device_get`` does that) and returns
the port's ``state_dict``: the same keys and values that
``encodec_pytorch_tpu.export.model_state_dict`` writes, built without jax.

Mapping (JAX → torch layout):

- ``SConv1d`` ``conv.{v,g,kernel,bias}``: ``v``/``kernel`` ``[k, in, out]`` →
  ``weight_v``/``weight`` ``[out, in, k]``; ``g`` ``[1, 1, out]`` →
  ``weight_g`` ``[out, 1, 1]``.
- ``SConvTranspose1d`` ``{v,g,kernel,bias}``: ``[k, out, in]`` →
  ``[in, out, k]``; ``g`` → ``[in, 1, 1]``.
- ``time_group_norm`` convs: ``GroupNorm_0`` ``scale``/``bias`` →
  ``conv.norm.weight``/``bias`` (``convtr.norm.*`` for a transposed conv).
- ``SLSTM`` ``w_ih_l{j} [in, 4H]``, ``w_hh_l{j} [H, 4H]``, ``b_l{j}`` →
  transposed weights, ``bias_ih = b`` and ``bias_hh = 0``.
- An int8 tree (``encodec_pytorch_tpu/prepare.py`` ``quantize_weights``):
  each ``{'q8', 'scale'}`` leaf in place of a ``kernel`` or an LSTM matrix
  becomes the int8 twin's (``prepare.quantize_weights``) buffers,
  ``weight_q8`` (transposed as ``weight`` is) and ``weight_scale`` (as it
  is: the JAX layout's trailing axis is dim 0 of torch's), or
  ``weight_{ih,hh}_l{j}_q8``/``_scale``. The twin loads it strictly.
- The quantizer's stage-stacked ``inited``, ``cluster_size``, ``embed`` and
  ``embed_avg`` (the whole RVQ training state) → one
  ``layers.{k}._codebook.*`` set per stage.
- The discriminator (``msstftd_state_dict``, the counterpart of
  ``encodec_pytorch_tpu/export.py`` ``msstftd_state_dict``): ``disc_{i}`` /
  ``conv_{j}`` ``{v,g,kernel,bias}`` with ``v``/``kernel`` ``[kh, kw, in, out]``
  → ``discriminators.{i}.convs.{j}.conv.weight_v``/``weight``
  ``[out, in, kh, kw]``, ``g`` → ``weight_g [out, 1, 1, 1]``, plus each
  scale's hann window; any channel count (``conv_0`` takes 2 per audio
  channel, ``conv_post`` gives ``out_channels``).

``train_state_from_jax`` takes a JAX ``TrainState`` with numpy leaves and
carries the whole of it across: the generator's and the discriminator's
state dicts (which the port's modules load with ``strict=True``), both optax
Adam states (``count``, ``mu``, ``nu`` become torch Adam's ``step``,
``exp_avg``, ``exp_avg_sq``, keyed by the port's parameter names through the
same mapping as the parameters; the summed LSTM bias's moments go to
``bias_ih``, the one that trains), the balancer's EMA (``total``, ``fix``)
and the step. :func:`adam_state_dict` turns one Adam state into what the
port's ``torch.optim.Adam.load_state_dict`` takes.

``lm_state_dict_from_jax`` takes the JAX ``LMModel`` param tree (numpy
leaves) to the port's ``models/lm.py`` state dict, the reference layout the
JAX package's ``export.lm_state_dict`` writes: ``emb_{k}.embedding`` →
``emb.{k}.weight``; ``linear_{k}`` and each layer's ``linear1``/``linear2``
``kernel [in, out]`` → ``weight [out, in]``; ``norm_in``, ``norm1``,
``norm2`` ``scale`` → ``weight``; the attention's packed ``in_proj_*`` and
``out_proj_*`` as they are (torch layout already).

``streaming_state_from_jax`` takes a JAX ``StreamingSEANet`` or
``StreamingCodec`` state (numpy leaves, NWC) and returns the port's
(``streaming.py``): the same keys, conv carries ``[B, T, C]`` → ``[B, C, T]``
and LSTM ``(h, c)`` ``[L, B, H]`` → ``[B, L, H]``, so a stream started in JAX
continues in the port.
"""

from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from .ops.stft import hann_window


def _f32(a) -> np.ndarray:
    return np.array(a, np.float32, copy=True, order='C')


def _emit_weight(sd: Dict[str, np.ndarray], key: str, leaf, transpose) -> None:
    """A weight leaf, transposed to torch's layout: f32 under ``key``, or an
    int8 ``{'q8', 'scale'}`` leaf as ``{key}_q8`` and ``{key}_scale``."""
    if isinstance(leaf, Mapping):
        if set(leaf) != {'q8', 'scale'}:
            raise ValueError(f'cannot convert leaves {sorted(leaf)} at {key}')
        sd[f'{key}_q8'] = np.array(np.transpose(leaf['q8'], transpose), np.int8, order='C')
        sd[f'{key}_scale'] = _f32(leaf['scale'])
    else:
        sd[key] = _f32(np.transpose(leaf, transpose))


def _emit_conv(sd: Dict[str, np.ndarray], prefix: str, sub: str, tree: Mapping):
    """One weight-normed, plain or ``time_group_norm`` conv subtree under
    ``{prefix}.{sub}``; weights are transposed from the JAX ``[k, a, b]``
    layout to torch's ``[b, a, k]``, and the GroupNorm's ``scale``/``bias``
    become ``{prefix}.norm.weight``/``bias``."""
    unknown = set(tree) - {'v', 'g', 'kernel', 'bias', 'GroupNorm_0'}
    if unknown:
        raise ValueError(f'cannot convert leaves {sorted(unknown)} at {prefix}')
    if 'v' in tree:
        sd[f'{prefix}.{sub}.weight_g'] = _f32(tree['g']).reshape(-1, 1, 1)
        sd[f'{prefix}.{sub}.weight_v'] = _f32(np.transpose(tree['v'], (2, 1, 0)))
    if 'kernel' in tree:
        _emit_weight(sd, f'{prefix}.{sub}.weight', tree['kernel'], (2, 1, 0))
    if 'bias' in tree:
        sd[f'{prefix}.{sub}.bias'] = _f32(tree['bias'])
    if 'GroupNorm_0' in tree:
        sd[f'{prefix}.norm.weight'] = _f32(tree['GroupNorm_0']['scale'])
        sd[f'{prefix}.norm.bias'] = _f32(tree['GroupNorm_0']['bias'])


def _emit_layer(sd: Dict[str, np.ndarray], prefix: str, tree: Mapping):
    keys = set(tree)
    if keys == {'conv'}:                                  # SConv1d
        _emit_conv(sd, f'{prefix}.conv', 'conv', tree['conv'])
    elif any(k.startswith('w_ih_l') for k in keys):       # SLSTM
        j = 0
        while f'w_ih_l{j}' in tree:
            b = _f32(tree[f'b_l{j}'])
            for m in ('ih', 'hh'):
                _emit_weight(sd, f'{prefix}.lstm.weight_{m}_l{j}', tree[f'w_{m}_l{j}'], (1, 0))
            sd[f'{prefix}.lstm.bias_ih_l{j}'] = b
            sd[f'{prefix}.lstm.bias_hh_l{j}'] = np.zeros_like(b)
            j += 1
    elif 'v' in keys or 'kernel' in keys:                 # SConvTranspose1d
        _emit_conv(sd, f'{prefix}.convtr', 'convtr', tree)
    elif keys and all(k.startswith('block_') or k == 'shortcut' for k in keys):
        for k in keys:                                    # SEANetResnetBlock
            sub = (f'{prefix}.shortcut' if k == 'shortcut'
                   else f"{prefix}.block.{k.split('_')[1]}")
            _emit_layer(sd, sub, tree[k])
    else:
        raise ValueError(f'unrecognized SEANet subtree at {prefix}: {sorted(keys)}')


def seanet_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX SEANetEncoder/Decoder param tree (``layer_{i}`` subtrees) →
    ``model.{i}...`` keys."""
    sd: Dict[str, np.ndarray] = {}
    for name in sorted(params, key=lambda s: int(s.split('_')[1])):
        _emit_layer(sd, f"model.{name.split('_')[1]}", params[name])
    return sd


def rvq_state_dict(state: Any) -> Dict[str, np.ndarray]:
    """Stage-stacked codebook state (a ``CodebookState`` or a mapping with
    its four fields) → ``layers.{k}._codebook.*`` keys."""
    fields = state._asdict() if hasattr(state, '_asdict') else dict(state)
    sd: Dict[str, np.ndarray] = {}
    for k in range(np.asarray(fields['embed']).shape[0]):
        p = f'layers.{k}._codebook'
        sd[f'{p}.inited'] = _f32(np.asarray(fields['inited'])[k]).reshape(1)
        sd[f'{p}.cluster_size'] = _f32(np.asarray(fields['cluster_size'])[k])
        sd[f'{p}.embed'] = _f32(np.asarray(fields['embed'])[k])
        sd[f'{p}.embed_avg'] = _f32(np.asarray(fields['embed_avg'])[k])
    return sd


def msstftd_state_dict(params: Mapping[str, Any],
                       win_lengths=(1024, 2048, 512)) -> Dict[str, np.ndarray]:
    """A JAX ``MultiScaleSTFTDiscriminator`` param tree → the port's keys."""
    sd: Dict[str, np.ndarray] = {}
    scales = sorted(params, key=lambda s: int(s.split('_')[1]))
    if len(scales) != len(win_lengths):
        raise ValueError(f'{len(scales)} scales but {len(win_lengths)} window lengths')
    for sname in scales:
        i = int(sname.split('_')[1])
        win = int(win_lengths[i])
        sd[f'discriminators.{i}.spec_transform.window'] = hann_window(win)
        for cname in sorted(params[sname], key=lambda c: (c == 'conv_post', c)):
            tree = params[sname][cname]
            prefix = (f'discriminators.{i}.conv_post.conv' if cname == 'conv_post'
                      else f"discriminators.{i}.convs.{cname.split('_')[1]}.conv")
            unknown = set(tree) - {'v', 'g', 'kernel', 'bias'}
            if unknown:
                raise ValueError(f'cannot convert leaves {sorted(unknown)} at {prefix}')
            if 'v' in tree:
                sd[f'{prefix}.weight_g'] = _f32(tree['g']).reshape(-1, 1, 1, 1)
                sd[f'{prefix}.weight_v'] = _f32(np.transpose(tree['v'], (3, 2, 0, 1)))
            if 'kernel' in tree:
                sd[f'{prefix}.weight'] = _f32(np.transpose(tree['kernel'], (3, 2, 0, 1)))
            if 'bias' in tree:
                sd[f'{prefix}.bias'] = _f32(tree['bias'])
    return sd


def train_state_from_jax(state: Any, win_lengths=(1024, 2048, 512)) -> Dict[str, Any]:
    """A JAX ``TrainState`` (numpy leaves) → ``{'model': generator and
    codebook state dict, 'disc': discriminator state dict, 'adam_g',
    'adam_d': {'step': int, 'exp_avg': {name: tensor}, 'exp_avg_sq': {...}},
    'balancer': {'total': {loss: tensor}, 'fix': {...}}, 'step': int}``."""
    model = state_dict_from_jax({'params': state.params_g, 'quantizer': state.quantizer})
    disc = _tensors(msstftd_state_dict(state.params_d, win_lengths))

    def adam(opt, to_sd):
        return {'step': int(np.asarray(opt.count)), 'exp_avg': _tensors(to_sd(opt.mu)),
                'exp_avg_sq': _tensors(to_sd(opt.nu))}

    return {'model': model, 'disc': disc,
            'adam_g': adam(state.opt_g, _generator_state_dict),
            'adam_d': adam(state.opt_d, lambda t: msstftd_state_dict(t, win_lengths)),
            'balancer': {name: {k: torch.from_numpy(_f32(v))
                                for k, v in getattr(state.balancer, name).items()}
                         for name in ('total', 'fix')},
            'step': int(np.asarray(state.step))}


def adam_state_dict(optimizer: torch.optim.Optimizer, module: torch.nn.Module,
                    adam: Mapping[str, Any]) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with its state replaced by ``adam`` (one
    entry of :func:`train_state_from_jax`); ``optimizer`` must hold
    ``module.parameters()`` in order, as ``train.step.make_optimizer`` builds it."""
    sd = optimizer.state_dict()
    named = list(module.named_parameters())
    if [len(g['params']) for g in sd['param_groups']] != [len(named)]:
        raise ValueError('the optimizer does not hold exactly the module\'s parameters')
    sd['state'] = {i: {'step': torch.tensor(float(adam['step'])),
                       'exp_avg': adam['exp_avg'][name].to(p),
                       'exp_avg_sq': adam['exp_avg_sq'][name].to(p)}
                   for i, (name, p) in enumerate(named)}
    return sd


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _generator_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The encoder and decoder of a JAX params tree (or of a tree of its
    shape, such as Adam's moments) → ``encoder.model...``/``decoder.model...``."""
    sd: Dict[str, np.ndarray] = {}
    for part in ('encoder', 'decoder'):
        for k, v in seanet_state_dict(params[part]).items():
            sd[f'{part}.{k}'] = v
    return sd


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX variables tree (numpy leaves) → this package's ``state_dict``,
    in the released key layout."""
    sd = _generator_state_dict(variables['params'])
    for k, v in rvq_state_dict(variables['quantizer']).items():
        sd[f'quantizer.vq.{k}'] = v
    return _tensors(sd)


def lm_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``LMModel`` param tree (numpy leaves) → the port's ``LMModel``
    state dict."""
    sd: Dict[str, np.ndarray] = {}
    for name, tree in params.items():
        if name.startswith('emb_'):
            sd[f"emb.{name.split('_')[1]}.weight"] = _f32(tree['embedding'])
        elif name.startswith('linear_'):
            k = name.split('_')[1]
            sd[f'linears.{k}.weight'] = _f32(np.transpose(tree['kernel']))
            sd[f'linears.{k}.bias'] = _f32(tree['bias'])
        elif name == 'transformer':
            for lname, ltree in tree.items():
                if lname == 'norm_in':
                    sd['transformer.norm_in.weight'] = _f32(ltree['scale'])
                    sd['transformer.norm_in.bias'] = _f32(ltree['bias'])
                    continue
                p = f"transformer.layers.{lname.split('_')[1]}"
                attn = ltree['self_attn']
                sd[f'{p}.self_attn.in_proj_weight'] = _f32(attn['in_proj_weight'])
                sd[f'{p}.self_attn.in_proj_bias'] = _f32(attn['in_proj_bias'])
                sd[f'{p}.self_attn.out_proj.weight'] = _f32(attn['out_proj_weight'])
                sd[f'{p}.self_attn.out_proj.bias'] = _f32(attn['out_proj_bias'])
                for ff in ('linear1', 'linear2'):
                    sd[f'{p}.{ff}.weight'] = _f32(np.transpose(ltree[ff]['kernel']))
                    sd[f'{p}.{ff}.bias'] = _f32(ltree[ff]['bias'])
                for norm in ('norm1', 'norm2'):
                    sd[f'{p}.{norm}.weight'] = _f32(ltree[norm]['scale'])
                    sd[f'{p}.{norm}.bias'] = _f32(ltree[norm]['bias'])
        else:
            raise ValueError(f'unrecognized LM subtree {name}')
    return _tensors(sd)


def streaming_state_from_jax(state: Union[Mapping, Tuple[Mapping, Mapping]]):
    """A JAX streaming state (one ``StreamingSEANet`` dict, or the
    ``(encoder, decoder)`` pair of a ``StreamingCodec``) with numpy leaves →
    the port's state, as CPU tensors."""
    if isinstance(state, tuple) and all(isinstance(s, Mapping) for s in state):
        return tuple(streaming_state_from_jax(s) for s in state)
    ncw = lambda a: torch.from_numpy(_f32(np.transpose(a, (0, 2, 1))))
    out: Dict[str, Any] = {}
    for name, leaf in state.items():
        if isinstance(leaf, Mapping):                       # a resblock's convs
            out[name] = {k: ncw(v) for k, v in leaf.items()}
        elif isinstance(leaf, (tuple, list)):               # LSTM (h, c)
            out[name] = tuple(torch.from_numpy(_f32(np.transpose(a, (1, 0, 2))))
                              for a in leaf)
        else:                                               # conv carry
            out[name] = ncw(leaf)
    return out
