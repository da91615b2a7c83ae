"""The port's multi-channel scene dataset, its wav IO, the mono-nq2 config
sets and the trainer through them, on the CPU, against the JAX package.

A seeded scene tree is made in the test (16-bit, 4 channels, 2 s a file;
``Park`` and ``Train Station`` at 48 kHz, so that their items go through the
resample). Checks:

- both packages' ``MultiChannelAudioDataset`` list the same files and fixed
  validation segments, and give bit-equal items over every index for 2
  epochs, in both modes, with and without ``fixed_length``; the batch loader
  over them gives bit-equal batches;
- the ported ``audio_io`` functions equal the JAX ones bit for bit on
  16-bit, 32-bit and float files; a ranged read of 24-bit PCM (which the JAX
  functions refuse: scipy will not memory-map 3-byte samples) equals scipy's
  full read, sliced;
- each key of ``config_mono_nq2`` and ``config_mono_nq2_resume`` equals the
  JAX package's yaml value (the port's own ``tpu`` keys aside);
- ``train_cli --config config_mono_nq2`` trains one epoch of 2 steps through
  the scene set on the CPU at a tiny width, tests and saves, with a
  tensorboard event file; ``--config config_mono_nq2_resume`` then trains
  epoch 2 from that file, and with ``tensorboardX`` made to fail to import it
  logs the JAX trainer's warning and goes on.
"""

import logging
import struct
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from encodec_pytorch_tpu.config import Config as JaxConfig
from encodec_pytorch_tpu.config import load_config as jax_load_config
from encodec_pytorch_tpu.data import audio_io as jaudio
from encodec_pytorch_tpu.data.dataset import DataLoader as JaxLoader
from encodec_pytorch_tpu.data.multi_channel import MultiChannelAudioDataset as JaxScenes
from encodec_pytorch_tpu_torch import config as tconfig
from encodec_pytorch_tpu_torch import train_cli
from encodec_pytorch_tpu_torch.data import DataLoader, MultiChannelAudioDataset, audio_io

SCENES = {'Beach': 24000, 'Park': 48000, 'Woodland': 24000, 'Train Station': 48000}


@pytest.fixture(scope='module')
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('scenes')
    rng = np.random.default_rng(0)
    for folder, sr in SCENES.items():
        (root / folder).mkdir()
        for i in range(2):
            t = np.arange(2 * sr) / sr
            tones = np.sin(2 * np.pi * rng.uniform(100, 3000, (1, 4)) * t[:, None])
            x = 0.3 * tones + 0.05 * rng.standard_normal((t.size, 4))
            wavfile.write(str(root / folder / f'scene{i}.wav'), sr,
                          (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return root


def _data(root, fixed_length: int) -> dict:
    return {'datasets': {'data_root': str(root), 'tensor_cut': 4800,
                         'fixed_length': fixed_length},
            'model': {'sample_rate': 24000, 'channels': 1}}


@pytest.mark.parametrize('mode', ['train', 'test'])
@pytest.mark.parametrize('fixed_length', [0, 6])
def test_scene_items_equal_jax(scene_root, mode, fixed_length):
    data = _data(scene_root, fixed_length)
    ours = MultiChannelAudioDataset(tconfig.Config(data), mode=mode, seed=3401)
    ref = JaxScenes(JaxConfig(data), mode=mode, seed=3401)
    assert ours.audio_files == ref.audio_files and len(ours.audio_files) == 4
    assert len(ours) == len(ref) == (fixed_length or 4)
    if mode == 'test':
        assert ours.fixed_segments == ref.fixed_segments
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ours)):
            got, want = ours[i], ref[i]
            assert got.dtype == want.dtype == np.float32 and got.shape == (1, 4800)
            np.testing.assert_array_equal(got, want)
    if mode == 'train':
        loaders = (DataLoader(ours, 2, fixed_length=4800, seed=3401),
                   JaxLoader(ref, 2, fixed_length=4800, seed=3401, prefetch=0))
        for epoch in (1, 2):
            for loader in loaders:
                loader.set_epoch(epoch)
            got, want = (list(loader) for loader in loaders)
            assert len(got) == len(want) == len(ours) // 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_audio_io_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.9, 0.9, (3, 1000)).astype(np.float32)
    files = {'pcm16': (x * 32767).astype(np.int16).T, 'pcm32': (x * 2 ** 31).astype(np.int32).T,
             'float': x.T, 'mono16': (x[0] * 32767).astype(np.int16)}
    for name, samples in files.items():
        path = tmp_path / f'{name}.wav'
        wavfile.write(str(path), 48000, samples)
        assert audio_io.wav_info(path) == jaudio.wav_info(path)
        for start, frames in ((0, None), (123, 400), (900, 400), (1000, 5)):
            got, sr = audio_io.read_wav(path, start, frames)
            want, sr_ref = jaudio.read_wav(path, start, frames)
            assert sr == sr_ref and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for sr, target in ((48000, 24000), (44100, 24000), (24000, 24000)):
        np.testing.assert_array_equal(audio_io.resample(x, sr, target),
                                      jaudio.resample(x, sr, target))
    audio_io.write_wav(tmp_path / 'ours.wav', x[:2], 24000)
    jaudio.write_wav(tmp_path / 'ref.wav', x[:2], 24000)
    assert (tmp_path / 'ours.wav').read_bytes() == (tmp_path / 'ref.wav').read_bytes()


def _write_pcm24(path, samples: np.ndarray, sr: int) -> None:
    """``[T, C]`` ints in [-2^23, 2^23) as 24-bit little-endian PCM."""
    frames, channels = samples.shape
    raw = (samples.astype('<i4').reshape(-1, 1).view(np.uint8)[:, :3]).tobytes()
    fmt = struct.pack('<HHIIHH', 1, channels, sr, sr * channels * 3, channels * 3, 24)
    body = b'WAVE' + b'fmt ' + struct.pack('<I', len(fmt)) + fmt + b'data' + \
        struct.pack('<I', len(raw)) + raw
    path.write_bytes(b'RIFF' + struct.pack('<I', len(body)) + body)


def test_pcm24_ranged_read_equals_a_sliced_full_read(tmp_path):
    rng = np.random.default_rng(2)
    samples = rng.integers(-2 ** 23, 2 ** 23, (3000, 5))
    path = tmp_path / 'scene24.wav'
    _write_pcm24(path, samples, 48000)
    sr, full = wavfile.read(str(path))            # int32, the sample in the top 24 bits
    np.testing.assert_array_equal(full, samples << 8)
    with pytest.raises(ValueError, match='3-byte'):
        jaudio.wav_info(path)                     # the JAX package cannot read it
    assert audio_io.wav_info(path) == (48000, 3000, 5)
    for start, frames in ((0, None), (17, 1000), (2500, 1000), (3000, 10)):
        got, got_sr = audio_io.read_wav(path, start, frames)
        end = None if frames is None else start + frames
        want = (full[start:end] / 2147483648.0).astype(np.float32).T
        assert got_sr == sr and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    mono = tmp_path / 'mono24.wav'
    _write_pcm24(mono, samples[:, :1], 24000)
    np.testing.assert_array_equal(audio_io.read_wav(mono, 5, 7)[0],
                                  (samples[5:12, :1].T << 8) / np.float32(2 ** 31))


def _walk(node: dict, prefix=''):
    for key, value in node.items():
        if isinstance(value, dict):
            yield from _walk(value, f'{prefix}{key}.')
        else:
            yield prefix + key, value


@pytest.mark.parametrize('name', ['config_mono_nq2', 'config_mono_nq2_resume'])
def test_mono_nq2_config_keys_equal_the_yaml(name):
    ours = tconfig.load_config(name=name).to_dict()
    ref = jax_load_config(name).to_dict()
    # the port's own keys, and the init method (torchrun's environment, not jax)
    port_only = {'tpu.disc_pallas_v2', 'tpu.disc_im2col', 'tpu.async_checkpoint',
                 'distributed.init_method'}
    keys = 0
    for key, value in _walk(ours):
        if key in port_only:
            continue
        want = ref
        for part in key.split('.'):
            want = want[part]
        # the yaml loader leaves '3e-4' and 'None' as strings; the port parses them
        assert value == want or value == tconfig.parse_value(str(want)), key
        keys += 1
    assert keys >= 30
    assert ours['datasets']['dataset'] == 'multi_channel' and ours['model']['n_q'] == 2
    assert ours['model']['train_discriminator'] == 0.5
    assert ours['tpu']['compute_dtype'] == 'float32'
    assert (ours['distributed']['init_method'], ref['distributed']['init_method']) == ('env',
                                                                                     'jax')


def test_train_cli_mono_nq2_trains_resumes_and_logs(scene_root, tmp_path, monkeypatch, caplog):
    save = tmp_path / 'ckpt'
    tiny = [f'datasets.data_root={scene_root}', f'checkpoint.save_folder={save}/',
            'datasets.batch_size=2', 'datasets.tensor_cut=4800', 'datasets.fixed_length=4',
            'common.save_interval=1', 'common.test_interval=1', 'common.log_interval=1',
            'model.n_filters=4', 'model.filters=4', 'model.disc_n_ffts=[256]',
            'model.disc_hop_lengths=[64]', 'model.disc_win_lengths=[256]',
            'lr_scheduler.warmup_epoch=0']
    trainer = train_cli.main(['--device', 'cpu', '--config', 'config_mono_nq2',
                              'common.max_epoch=1', *tiny])
    assert isinstance(trainer.trainset, MultiChannelAudioDataset)
    assert trainer.model.quantizer.n_q == 2 and trainer.disc_prob == 0.5
    summary = trainer.history[-1]
    assert summary['steps'] == 2 and len(trainer.data_ms) == 2
    assert all(np.isfinite(v) for k, v in summary.items() if k != 'step_ms')
    assert [t['epoch'] for t in trainer.test_history] == [0, 1]
    ckpt = save / 'bs2_cut4800_length4_epoch1_lr0.0003.ckpt'
    assert ckpt.exists() and (save / 'Reconstruction.wav').exists()
    events = b''.join(f.read_bytes() for f in (save / 'runs').glob('events.out.tfevents.*'))
    for tag in (b'Train/Loss_G', b'Train/l_f', b'Train/Loss_W', b'Train/Loss_Disc',
                b'Train/codebook_entropy', b'Test/l_t', b'Test/loss_disc'):
        assert tag in events, tag
    assert b'Test/ms' not in events

    monkeypatch.setitem(sys.modules, 'tensorboardX', None)      # import fails
    with caplog.at_level(logging.WARNING, logger='encodec_pytorch_tpu_torch'):
        resumed = train_cli.main(['--device', 'cpu', '--config', 'config_mono_nq2_resume',
                                  f'checkpoint.checkpoint_path={ckpt}', 'common.max_epoch=2',
                                  *tiny])
    assert 'tensorboard unavailable' in caplog.text
    assert resumed.resume_epoch == 1 and resumed.step == 4
    assert len(resumed.history) == 1 and resumed.history[0]['steps'] == 2
    assert all(np.isfinite(v) for k, v in resumed.history[0].items() if k != 'step_ms')
    assert (save / 'bs2_cut4800_length4_epoch2_lr0.0003.ckpt').exists()
