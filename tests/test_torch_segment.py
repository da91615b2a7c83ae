"""Segment-parallel inference in the port (``parallel/segment.py``) on the CPU.

The JAX package's tests/test_segment_parallel.py model (24 kHz, non-causal
``time_group_norm``, normalizing, 0.1 s segments, ``n_filters`` 4, ``n_q``
2). Bars:

- one process: ``roundtrip_parallel`` against the sequential ``model(x)``
  and against the JAX package's ``roundtrip_parallel`` on the same weights
  (carried by ``convert.state_dict_from_jax``), atol 2e-5 (the JAX test's bar
  for parallel against sequential); the codes equal the sequential
  ``encode``'s exactly;
- two ranks over gloo (``tests/torch_segment_ranks.py``, spawned, a time
  limit of their own), at a full-segment count the ranks divide and at one
  they do not: both ranks return the same frames and wav, bit for bit, and
  so does one process.
"""

import os
import sys

import jax
import numpy as np
import torch

from encodec_pytorch_tpu.models.model import EncodecModel as JaxModel
from encodec_pytorch_tpu.parallel.segment import roundtrip_parallel as jax_roundtrip
from encodec_pytorch_tpu_torch import convert
from encodec_pytorch_tpu_torch.models.model import EncodecModel
from encodec_pytorch_tpu_torch.parallel.segment import encode_parallel, roundtrip_parallel
from test_torch_deploy import numpy_params_gn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_segment_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

RANK_TIMEOUT = 60


def test_one_process_matches_sequential_and_jax():
    """8 full segments and a tail, as in the JAX test."""
    jm = JaxModel._get_model(**ranks.CONFIG)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), example_length=2400))
    rng = np.random.default_rng(0)
    n_q, bins, dim = shapes['quantizer'].embed.shape
    embed = rng.standard_normal((n_q, bins, dim)).astype(np.float32)
    variables = {'params': numpy_params_gn(shapes['params'], rng),
                 'quantizer': shapes['quantizer']._replace(
                     inited=np.ones(n_q, np.float32), cluster_size=np.ones((n_q, bins), np.float32),
                     embed=embed, embed_avg=embed)}
    jm.set_target_bandwidth(3.)
    tm = EncodecModel._get_model(**ranks.CONFIG).eval()
    tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    tm.set_target_bandwidth(3.)
    x = (rng.standard_normal((1, 1, 2400 * 8 + 1000)) * 0.2).astype(np.float32)
    xt = torch.from_numpy(x)
    par = roundtrip_parallel(tm, xt).numpy()
    np.testing.assert_allclose(par, tm(xt).numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(par, np.asarray(jax_roundtrip(jm, variables, x)), atol=2e-5,
                               rtol=0)
    frames, seq = encode_parallel(tm, xt), tm.encode(xt)
    assert len(frames) == len(seq) == 9 and frames[-1][0].shape[-1] < frames[0][0].shape[-1]
    for (c, _), (ref, _) in zip(frames, seq):
        np.testing.assert_array_equal(c.numpy(), ref.numpy())


def test_two_ranks_bit_equal_to_each_other_and_one_process(tmp_path):
    procs = ranks.launch(str(tmp_path / 'rank'))
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = [torch.load(tmp_path / f'rank{r}.pt', weights_only=True) for r in range(2)]
    single = ranks.run()
    for name in ranks.CLIPS:
        for r in range(2):
            for key in ('codes', 'scales'):
                assert len(got[r][name][key]) == len(single[name][key])
                for a, b in zip(got[r][name][key], single[name][key]):
                    assert torch.equal(a, b), (name, r, key)
            assert torch.equal(got[r][name]['wav'], single[name]['wav']), (name, r)
