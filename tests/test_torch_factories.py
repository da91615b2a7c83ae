"""The trained-checkpoint factories (``my_encodec``, ``encodec_bw``) of the
port against the JAX package's, on the CPU.

A trainer-layout file (``{'epoch', 'model_state_dict'}``, the quantizer
under ``quantizer.model``) is written from numpy-seeded JAX variables by the
JAX package's own exporter (``export.save_torch_checkpoint(style='trainer')``),
at n_q 4 and ratios (8, 4) for ``my_encodec`` (its n_filters is fixed at 32;
two SEANet stages keep the JAX encoder's compile short) and at the full
ratios for ``encodec_bw``, which takes none. Bars: codes exactly equal,
decoded audio within 1e-5 of max|ref| (f32, different summation orders),
n_q read from the file. Also: the port's trainer checkpoint loads into
``my_encodec`` strictly and encodes as the trainer's generator does, a
default-config (causal, weight-norm) trainer file fails with the key names,
and ``cli -m my_encodec`` / ``-m encodec_bw`` round trips.
"""

from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu import export
from encodec_pytorch_tpu.models import model as JM
from encodec_pytorch_tpu_torch import cli
from encodec_pytorch_tpu_torch.config import load_config
from encodec_pytorch_tpu_torch.models.model import (MODELS, encodec_model_bw, my_encodec_model,
                                                    trainer_state_dict)
from encodec_pytorch_tpu_torch.train.trainer import Trainer
from encodec_pytorch_tpu_torch.utils import read_wav, write_wav
from test_torch_disc import close
from test_torch_ops import numpy_params

torch.set_num_threads(1)


def _seeded_variables(jm, rng, length: int):
    """Seeded JAX variables of ``jm``: parameters from ``numpy_params`` (and
    GroupNorm scales near 1), random-normal codebooks, all inited."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), example_length=length))

    def fill(shape_tree, tree):
        out = {}
        for name, leaf in shape_tree.items():
            if isinstance(leaf, Mapping):
                out[name] = fill(leaf, tree.get(name, {}))
            elif name in tree:
                out[name] = tree[name]
            else:                              # GroupNorm scale
                out[name] = (1 + rng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32)
        return out

    params = fill(shapes['params'], numpy_params(shapes['params'], rng))
    n_q, bins, dim = shapes['quantizer'].embed.shape
    embed = rng.standard_normal((n_q, bins, dim)).astype(np.float32)
    quantizer = shapes['quantizer']._replace(
        inited=np.ones(n_q, np.float32),
        cluster_size=rng.uniform(0, 5, (n_q, bins)).astype(np.float32),
        embed=embed, embed_avg=(embed * 2).astype(np.float32))
    return {'params': params, 'quantizer': quantizer}


def _wav(length, seed):
    return (np.random.default_rng(seed).standard_normal((1, 1, length)) * 0.1
            ).astype(np.float32)


def _jax_round_trip(jm, variables, x):
    frames = jax.jit(lambda v, x: jm.encode(v, x))(variables, jnp.asarray(x))
    out = jax.jit(lambda v, f: jm.decode(v, f))(variables, frames)
    return [np.asarray(c) for c, _ in frames], np.asarray(out)


def _port_round_trip(model, x):
    frames = model.encode(torch.from_numpy(x))
    return [c.numpy() for c, _ in frames], model.decode(frames).numpy()


@pytest.fixture(scope='module')
def my_encodec_file(tmp_path_factory):
    ratios = (8, 4)
    jm = JM.EncodecModel._get_model(
        [1.5, 3., 6, 12., 24.], 24_000, 1, causal=False, model_norm='time_group_norm',
        audio_normalize=True, segment=None, name='my_encodec', ratios=ratios, n_q=4)
    variables = _seeded_variables(jm, np.random.default_rng(4), 2400)
    path = str(tmp_path_factory.mktemp('ckpt') / 'trained.ckpt')
    export.save_torch_checkpoint(variables, path, style='trainer', epoch=3)
    return path, ratios


def test_my_encodec_matches_jax(my_encodec_file):
    path, ratios = my_encodec_file
    assert all(k.startswith(('encoder.', 'decoder.', 'quantizer.model.'))
               for k in torch.load(path, weights_only=True)['model_state_dict'])
    jm, jvars = JM.my_encodec_model(path, ratios=ratios)
    model = my_encodec_model(path, ratios=ratios, device='cpu')
    assert model.quantizer.n_q == jm.quantizer.n_q == 4
    assert (model.name, model.normalize, model.segment, model.encoder.causal) == (
        'my_encodec', True, None, False)
    x = _wav(4000, 1)
    codes_ref, out_ref = _jax_round_trip(jm, jvars, x)
    codes, out = _port_round_trip(model, x)
    assert len(codes) == len(codes_ref) == 1 and codes[0].shape == (1, 4, 125)
    np.testing.assert_array_equal(codes[0], codes_ref[0])
    close(out, out_ref)


@pytest.mark.parametrize('bandwidth', [6., [1.5, 3., 6.]], ids=['scalar', 'list'])
def test_encodec_bw_matches_jax(tmp_path, bandwidth):
    """1 s segments: a 1.2 s clip is two frames, each with its scale."""
    jm0 = JM.EncodecModel._get_model(
        [6.], 24_000, 1, causal=False, model_norm='time_group_norm', audio_normalize=True,
        segment=1., name='my_encodec')
    variables = _seeded_variables(jm0, np.random.default_rng(5), 24000)
    path = str(tmp_path / 'bw.ckpt')
    export.save_torch_checkpoint(variables, path, style='trainer')
    jm, jvars = JM.encodec_model_bw(path, bandwidth)
    model = encodec_model_bw(path, bandwidth, device='cpu')
    bandwidths = bandwidth if isinstance(bandwidth, list) else [bandwidth]
    assert model.target_bandwidths == bandwidths == list(jm.target_bandwidths)
    assert (model.segment, model.quantizer.n_q) == (1., 8)
    x = _wav(28800, 2)
    codes_ref, out_ref = _jax_round_trip(jm, jvars, x)
    codes, out = _port_round_trip(model, x)
    assert len(codes) == len(codes_ref) == 2
    for a, b in zip(codes, codes_ref):
        np.testing.assert_array_equal(a, b)
    close(out, out_ref)


def _trainer(tmp_path, *overrides):
    """A tiny trainer on the CPU, pinned to float32: its generator is held
    bit-exactly to the same weights loaded into the float32 factories."""
    rng = np.random.default_rng(6)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f'{i}.wav'))
        write_wav(paths[-1], rng.uniform(-0.3, 0.3, (1, 3200)).astype(np.float32), 24000)
    (tmp_path / 'data.csv').write_text('\n'.join(paths) + '\n')
    return Trainer(load_config([
        f'datasets.train_csv_path={tmp_path / "data.csv"}',
        f'datasets.test_csv_path={tmp_path / "data.csv"}', 'datasets.tensor_cut=3200',
        'datasets.batch_size=2', 'model.n_q=4', 'model.filters=4', 'model.disc_n_ffts=[256]',
        'model.disc_hop_lengths=[64]', 'model.disc_win_lengths=[256]',
        f'checkpoint.save_folder={tmp_path}/', 'tpu.async_checkpoint=False',
        'tpu.compute_dtype=float32', *overrides]), device='cpu')


def test_trainer_checkpoint_loads_into_my_encodec(tmp_path):
    """The port's trainer, trained with the overrides that give the
    ``my_encodec`` architecture, writes a file the factory loads strictly;
    a default-config (causal, weight-norm) file is refused by key name."""
    trainer = _trainer(tmp_path, 'model.causal=False', 'model.norm=time_group_norm',
                       'model.ratios=[8,4]')
    trainer.train_one_epoch(1)
    path = trainer.save(1)
    model = my_encodec_model(path, ratios=(8, 4), device='cpu')
    x = torch.from_numpy(_wav(3200, 3))
    trainer.model.eval()
    assert torch.equal(model.encode(x)[0][0], trainer.model.encode(x)[0][0])
    state = trainer_state_dict(path)
    assert set(state) == set(trainer.model.state_dict())

    wrong = _trainer(tmp_path / 'causal', 'model.ratios=[8,4]')
    with pytest.raises(RuntimeError, match='weight_v'):
        my_encodec_model(wrong.save(1), ratios=(8, 4), device='cpu')


def test_cli_round_trips_trained_checkpoints(tmp_path, monkeypatch):
    """``cli -m my_encodec`` and ``-m encodec_bw`` at full width on a
    trainer-layout file: the CLI's wav equals the factory's decode."""
    monkeypatch.chdir(tmp_path)
    jm = JM.EncodecModel._get_model(
        [1.5, 3., 6, 12., 24.], 24_000, 1, causal=False, model_norm='time_group_norm',
        audio_normalize=True, segment=None, name='my_encodec', n_q=8)
    variables = _seeded_variables(jm, np.random.default_rng(7), 2400)
    ckpt = str(tmp_path / 'trained.ckpt')
    export.save_torch_checkpoint(variables, ckpt, style='trainer')
    clip = _wav(12000, 8)[0]
    write_wav(tmp_path / 'in.wav', clip, 24000)
    for name in ('my_encodec', 'encodec_bw'):
        common = ['-m', name, '-c', ckpt, '-b', '6', '--device', 'cpu', '-f']
        cli.main(['in.wav', f'{name}.ecdc', *common])
        cli.main([f'{name}.ecdc', f'{name}.wav', *common])
        out, sr = read_wav(tmp_path / f'{name}.wav')
        model = (MODELS[name](ckpt, 6., device='cpu') if name == 'encodec_bw'
                 else MODELS[name](ckpt, device='cpu'))
        model.set_target_bandwidth(6.)
        ref = model(torch.from_numpy(read_wav(tmp_path / 'in.wav')[0][None]))[0].numpy()
        assert sr == 24000 and out.shape == (1, 12000)
        assert np.abs(out - np.clip(ref, -0.99, 0.99)).max() <= 2 / 32768
