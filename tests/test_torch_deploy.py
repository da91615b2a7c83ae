"""The port's deployment artifacts (``encodec_pytorch_tpu_torch/deploy.py``,
``deploy_cli.py``) on the CPU, against the JAX package's ``deploy.py``.

Tiny models (``n_filters`` 4, ``n_q`` 2), weights numpy-seeded on the JAX side
and carried into the port by ``convert.state_dict_from_jax``. Bars:

- a causal weight-norm artifact of two lengths and two bandwidths against the
  JAX package's ``save_artifact``/``DeployedCodec`` on the same weights: the
  metas' entries equal, codes exact, wav within atol 1e-5 (both compute weight
  norm and the convs in f32 in other orders);
- the segmented, normalizing, ragged case against the port's ``LiveCodec``
  (codes and scales exact, wav atol 1e-6: the same arithmetic in one graph)
  and the JAX ``LiveCodec``'s codes (exact; the 48 kHz decode against JAX is
  ``tests/test_torch_48k.py``'s);
- the exported graphs hold K1, K2 and K3 as ``encodec::*`` nodes, and no
  unrolled recurrence or argmax search;
- the kinds-subset roundtrip fallback, the loader's errors, ``deploy_cli``'s
  refusals, a ``CodecServer`` over a ``DeployedCodec``, a fresh interpreter
  that runs an artifact with the port's ``models`` never imported, and the
  refusal to load onto a card that is not there.

Each export is ~1-2 s of tracing on a CPU, so the artifacts are made once a
module and hold as few entries as each check needs.
"""

import io
import json
import os
import subprocess
import sys
import zipfile
from collections import Counter
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodec_pytorch_tpu import deploy as jdeploy
from encodec_pytorch_tpu import serve as jserve
from encodec_pytorch_tpu.models.model import EncodecModel as JaxModel
from encodec_pytorch_tpu_torch import convert, deploy, deploy_cli, prepare
from encodec_pytorch_tpu_torch.models import model as tmodel
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec
from test_torch_ops import numpy_params

torch.set_num_threads(1)

TIMEOUT = 60
LENGTHS = [1200, 2400]
# both past the 2 stages (a codebook is 6 kbps at 600 frames a second): the
# metas' n_q come from the encode, clamped, and both bandwidths share programs
BANDWIDTHS = [12., 24.]
# two SEANet stages (hop 40): tracing costs ~10 ms a graph node on a CPU, and a
# segmented program traces two encoders (the full segments, the tail) with a
# GroupNorm a conv, several seconds a program at four stages
CAUSAL = dict(target_bandwidths=BANDWIDTHS, sample_rate=24000, channels=1, causal=True,
              model_norm='weight_norm', name='encodec_24khz', n_q=2, n_filters=4,
              ratios=(8, 5))
SEGMENTED = dict(CAUSAL, causal=False, model_norm='time_group_norm', audio_normalize=True,
                 segment=0.1)


def numpy_params_gn(shapes: Mapping, rng: np.random.Generator) -> dict:
    """``numpy_params`` with each GroupNorm's ``scale`` in [0.5, 1.5] (the
    helper of ``tests/test_torch_48k.py``, whose imports cost ~3 s)."""
    out = numpy_params(shapes, rng)

    def fill(shape_tree, tree):
        for name, leaf in shape_tree.items():
            if isinstance(leaf, Mapping):
                fill(leaf, tree.setdefault(name, {}))
            elif name == 'scale':
                tree[name] = rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    fill(shapes, out)
    return out


def _pair(config, params):
    """(JAX model, its variables, the port model on the same weights)."""
    jm = JaxModel._get_model(**config)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), example_length=2400))
    rng = np.random.default_rng(0)
    n_q, bins, dim = shapes['quantizer'].embed.shape
    embed = rng.standard_normal((n_q, bins, dim)).astype(np.float32)
    variables = {'params': params(shapes['params'], rng),
                 'quantizer': shapes['quantizer']._replace(
                     inited=np.ones(n_q, np.float32), cluster_size=np.ones((n_q, bins), np.float32),
                     embed=embed, embed_avg=embed)}
    bandwidth = config['target_bandwidths'][-1]
    jm.set_target_bandwidth(bandwidth)
    tm = EncodecModel._get_model(**config)
    tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    tm.eval().set_target_bandwidth(bandwidth)
    return jm, variables, tm


def _wav(batch, length, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 1, length)) * scale).astype(np.float32)


@pytest.fixture(scope='module')
def causal(tmp_path_factory):
    """Both packages' encode + decode artifacts of the causal model (the JAX
    one lowered for the CPU alone: the comparison runs there)."""
    jm, variables, tm = _pair(CAUSAL, numpy_params)
    root = tmp_path_factory.mktemp('causal')
    kinds = ['encode', 'decode']
    jmeta = jdeploy.save_artifact(root / 'jax.ecdz', jm, variables, lengths=LENGTHS,
                                  bandwidths=BANDWIDTHS, platforms=('cpu',), kinds=kinds)
    meta = deploy.save_artifact(root / 'port.ecdz', tm, LENGTHS, BANDWIDTHS, kinds=kinds)
    return dict(jm=jm, variables=variables, tm=tm, root=root, jmeta=jmeta, meta=meta,
                jcodec=jdeploy.DeployedCodec.load(root / 'jax.ecdz'),
                codec=deploy.DeployedCodec.load(root / 'port.ecdz', device='cpu'))


@pytest.fixture(scope='module')
def segmented(tmp_path_factory):
    jm, variables, tm = _pair(SEGMENTED, numpy_params_gn)
    stride = tm.segment_stride
    length = stride + stride // 2      # a full segment and a ragged tail
    path = tmp_path_factory.mktemp('segmented') / 'codec48.ecdz'
    deploy.save_artifact(path, tm, [length], kinds=['encode', 'decode'])
    return dict(jm=jm, variables=variables, tm=tm, path=path, length=length,
                codec=deploy.DeployedCodec.load(path, device='cpu'))


@pytest.fixture(scope='module')
def cli_artifact(tmp_path_factory):
    """``deploy_cli`` on the CPU: one roundtrip entry of a shallow causal model."""
    tm = EncodecModel._get_model(**CAUSAL, generator=torch.Generator().manual_seed(2)).eval()
    for layer in tm.quantizer.vq.layers:
        layer._codebook.embed.normal_(generator=torch.Generator().manual_seed(3))
    out = tmp_path_factory.mktemp('cli') / 'a.ecdz'
    patch = pytest.MonkeyPatch()
    patch.setitem(tmodel.MODELS, 'encodec_24khz', lambda checkpoint=None, device=None: tm)
    try:
        meta = deploy_cli.main([str(out), '-m', 'encodec_24khz', '-c', 'seeded.th',
                                '--seconds', '0.05', '--bandwidths', '24', '--kinds',
                                'roundtrip', '--device', 'cpu'])
    finally:
        patch.undo()
    return tm, out, meta


@pytest.fixture(scope='module')
def fresh_interpreter(cli_artifact, tmp_path_factory):
    """A new Python process that loads the CLI's artifact and runs it, started
    here and read by the last test: (the process, its input, its output file)."""
    _, path, _ = cli_artifact
    folder = tmp_path_factory.mktemp('fresh')
    x = _wav(2, 1200, seed=6)
    np.save(folder / 'x.npy', x)
    script = (
        'import sys, numpy as np, torch\n'
        'from encodec_pytorch_tpu_torch.deploy import DeployedCodec\n'
        f'codec = DeployedCodec.load({str(path)!r}, device="cpu")\n'
        f'wav = codec.roundtrip(np.load({str(folder / "x.npy")!r}))\n'
        f'np.save({str(folder / "wav.npy")!r}, wav.numpy())\n'
        'assert not any(m.startswith("encodec_pytorch_tpu_torch.models") for m in sys.modules)\n'
        'assert "jax" not in sys.modules\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, '-c', script], cwd=root, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS='1'))
    yield proc, x, folder / 'wav.npy'
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_deploy_cli(cli_artifact, fresh_interpreter, tmp_path, monkeypatch):
    """The CLI's artifact equals the model; its refusals exit 1 (argparse's 2).
    First in the file, so that the fresh interpreter (``fresh_interpreter``)
    runs beside the exports of the tests after it."""
    tm, out, meta = cli_artifact
    assert [e['name'] for e in meta['entries']] == ['roundtrip_bw24_t1200']
    codec = deploy.DeployedCodec.load(out, device='cpu')
    x = _wav(2, 1200, seed=4)
    np.testing.assert_allclose(codec.roundtrip(x).numpy(), tm(torch.from_numpy(x)).numpy(),
                               atol=1e-6, rtol=0)
    monkeypatch.setitem(tmodel.MODELS, 'encodec_24khz', lambda checkpoint=None, device=None: tm)
    args = [str(out), '-c', 'seeded.th', '--device', 'cpu']
    for argv in (args,                                      # exists, no -f
                 args + ['-f', '--bandwidths', '48'],       # a bandwidth the model lacks
                 [str(out), '-f', '--device', 'cpu'],       # no weights
                 [str(tmp_path / 'b.ecdz'), '-m', 'my_encodec', '--device', 'cpu']):
        with pytest.raises(SystemExit) as e:
            deploy_cli.main(argv)
        assert e.value.code == 1, argv
    with pytest.raises(SystemExit) as e:
        deploy_cli.main(args + ['-f', '--platforms', 'tpu'])
    assert e.value.code == 2
    seg = EncodecModel._get_model(**SEGMENTED).eval()
    monkeypatch.setitem(tmodel.MODELS, 'encodec_48khz', lambda checkpoint=None, device=None: seg)
    with pytest.raises(SystemExit) as e:
        deploy_cli.main([str(tmp_path / 'c.ecdz'), '-m', 'encodec_48khz', '-c', 'x.th',
                         '--weights', 'fold', '--device', 'cpu'])
    assert e.value.code == 1 and not (tmp_path / 'c.ecdz').exists()


def test_artifact_matches_jax(causal):
    """Metas' entries equal; at every (bandwidth, length) codes exact and the
    wav within 1e-5 of the JAX artifact's (its entries of the highest
    bandwidth: both bandwidths code the model's 2 stages, as the metas say,
    and each JAX program compiles on its first call); the batch is dynamic
    (1 and 3)."""
    jmeta, meta = causal['jmeta'], causal['meta']
    assert meta['entries'] == jmeta['entries'] and len(meta['entries']) == 8
    assert {e['n_q'] for e in meta['entries']} == {2}
    for key in set(jmeta) - {'entries', 'platforms'}:
        assert meta[key] == jmeta[key], key
    assert meta['platforms'] == ['cpu', 'cuda']
    codec, jcodec, tm = causal['codec'], causal['jcodec'], causal['tm']
    assert codec.lengths == LENGTHS and codec.bandwidths == BANDWIDTHS
    for length in LENGTHS:
        x = _wav(3, length, seed=length)
        jcodes = jcodec.encode(x, bandwidth=BANDWIDTHS[-1])
        jwav = np.asarray(jcodec.decode(jcodes, bandwidth=BANDWIDTHS[-1], length=length))
        for bw in BANDWIDTHS:
            codes = codec.encode(x, bandwidth=bw)
            assert len(codes) == len(jcodes) == 1
            np.testing.assert_array_equal(codes[0].numpy(), np.asarray(jcodes[0]))
            wav = codec.decode(codes, bandwidth=bw, length=length).numpy()
            np.testing.assert_allclose(wav, jwav, atol=1e-5, rtol=0)
    x = _wav(1, 2400, seed=9)
    one = codec.encode(x)
    np.testing.assert_array_equal(one[0].numpy(), tm.encode(torch.from_numpy(x))[0][0].numpy())


def _targets(codec):
    return {name: Counter(str(n.target) for n in prog.graph.nodes if n.op == 'call_function')
            for name, prog in codec._programs.items()}


def test_graph_holds_the_kernel_ops(causal, segmented):
    """Exported on the CPU, every encode holds one K1 node, every encode and
    decode two K2 nodes (two LSTM layers) and, for weight-norm blocks, one K3
    node a block; nothing of the plain versions' recurrence or search."""
    for name, ops in _targets(causal['codec']).items():
        assert ops['encodec.rvq_encode.default'] == (name.startswith('encode'))
        assert ops['encodec.lstm_recurrence.default'] == 2
        assert ops['encodec.resblock.default'] == len(CAUSAL['ratios'])
        assert not any(k in t for t in ops for k in ('sigmoid', 'tanh', 'argmax')), ops
    for name, ops in _targets(segmented['codec']).items():
        # two calls a program (the full segments, then the tail); time_group_norm
        # blocks stay convs (K3 cannot fuse their GroupNorms)
        assert ops['encodec.resblock.default'] == 0
        assert ops['encodec.lstm_recurrence.default'] == 4
        assert ops['encodec.rvq_encode.default'] == (2 if name.startswith('encode') else 0)
    # the codebook tables are computed in the traced program: a fake tensor has
    # no data pointer to key the live cache on
    vq = causal['tm'].quantizer.vq
    ep = torch.export.export(_Tables(vq), (torch.zeros(2, 5, 128),))
    assert 'aten.stack.default' in {str(n.target) for n in ep.graph.nodes}
    embed, esq = vq.tables(2)
    assert vq.tables(2)[0] is embed                           # the live path still caches


class _Tables(torch.nn.Module):
    def __init__(self, vq):
        super().__init__()
        self.vq = vq

    def forward(self, x):
        from encodec_pytorch_tpu_torch.quantization.core_vq import rvq_encode
        return rvq_encode(*self.vq.tables(2), x)


def test_segmented_normalized_ragged(segmented):
    """Segments (and the shorter last one) and their scales live inside the
    programs: equal to the port's LiveCodec and the JAX LiveCodec."""
    codec, tm, length = segmented['codec'], segmented['tm'], segmented['length']
    jm, variables = segmented['jm'], segmented['variables']
    x = _wav(2, length, seed=3, scale=0.2)
    live = LiveCodec(tm, device='cpu')
    ref = live.roundtrip(x).numpy()
    np.testing.assert_allclose(codec.roundtrip(x).numpy(), ref, atol=1e-6, rtol=0)
    codes, scales = codec.encode(x)
    lcodes, lscales = live.encode(x)
    jcodes, jscales = jserve.LiveCodec(jm, variables).encode(x)
    assert len(codes) == len(jcodes) == 2 and codes[-1].shape[-1] < codes[0].shape[-1]
    for c, lc, jc in zip(codes, lcodes, jcodes):
        np.testing.assert_array_equal(c.numpy(), lc.numpy())
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert scales[0].shape == (2, 1)
    np.testing.assert_array_equal(torch.cat(scales).numpy(), torch.cat(lscales).numpy())
    dec = codec.decode(codes, scales).numpy()                 # matched by shapes, no length
    np.testing.assert_allclose(dec, ref, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match='normalize'):
        codec.decode(codes, length=length)


def test_kinds_subset_fallback_and_loader_errors(causal, segmented, tmp_path):
    """An artifact without roundtrip entries composes encode∘decode; the
    roundtrip entry is about a third of a full artifact; the loader refuses
    another format, an unserved length and a card that is not there."""
    codec, tm = causal['codec'], causal['tm']
    x = _wav(2, 2400, seed=5)
    tm.set_target_bandwidth(12.)
    np.testing.assert_allclose(codec.roundtrip(x, bandwidth=12.).numpy(),
                               tm(torch.from_numpy(x)).numpy(), atol=1e-6, rtol=0)
    tm.set_target_bandwidth(24.)
    with zipfile.ZipFile(segmented['path']) as zf:
        sizes = {i.filename: i.file_size for i in zf.infolist()}
        meta = json.loads(zf.read('meta.json'))
    assert set(sizes) == {'meta.json'} | {e['name'] + '.pt2' for e in meta['entries']}
    # each entry holds only what it reads: the encoder's or the decoder's weights
    # and the codebooks it uses (n_q 2 of 2 here)
    assert max(sizes.values()) < 0.75 * sum(sizes.values())
    with pytest.raises(ValueError, match='unknown kinds'):
        deploy.save_artifact(tmp_path / 'x.ecdz', tm, [1200], kinds=['encode', 'stream'])
    with pytest.raises(ValueError, match='int8'):
        deploy.save_artifact(tmp_path / 'x.ecdz', prepare.prepare_for_inference(tm, 'int8'),
                             [1200])
    with pytest.raises(KeyError, match='serves lengths'):
        codec.roundtrip(np.zeros((1, 1, 999), np.float32))
    with pytest.raises(KeyError, match='match 0 decode entries'):
        codec.decode((np.zeros((1, 4, 5), np.int32),))
    bad = tmp_path / 'v2.ecdz'
    with zipfile.ZipFile(segmented['path']) as src, zipfile.ZipFile(bad, 'w') as dst:
        dst.writestr('meta.json', json.dumps(dict(meta, format_version=2)))
    with pytest.raises(ValueError, match='artifact format 2'):
        deploy.DeployedCodec.load(bad, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            deploy.DeployedCodec.load(segmented['path'])


def test_codec_server_over_deployed(causal):
    """The JAX test_serve.py:238 case: a CodecServer serves the artifact and
    every result equals a direct call."""
    codec = causal['codec']
    rng = np.random.default_rng(7)
    clips = [(rng.standard_normal((1, 2400)) * 0.1).astype(np.float32) for _ in range(3)]
    with CodecServer(codec, max_batch=4, max_wait_ms=1.0) as server:
        outs = [server.roundtrip(c, bandwidth=24., timeout=TIMEOUT) for c in clips]
    for c, out in zip(clips, outs):
        ref = codec.roundtrip(c[None], bandwidth=24.)[0].numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    with pytest.raises(TypeError, match='DeployedCodec.load'):
        CodecServer(str(causal['root'] / 'port.ecdz'))


def test_fresh_interpreter_runs_artifact_without_models(cli_artifact, fresh_interpreter):
    """The artifact needs torch and the kernel operators only: a new process
    loads and runs it and never imports the port's models (nor jax)."""
    tm, _, _ = cli_artifact
    proc, x, out = fresh_interpreter
    _, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-2000:]
    np.testing.assert_allclose(np.load(out), tm(torch.from_numpy(x)).numpy(), atol=1e-6, rtol=0)
