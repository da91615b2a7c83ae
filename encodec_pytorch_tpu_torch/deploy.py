"""Self-contained deployment artifacts: the codec as ``torch.export`` programs.

Port of ``encodec_pytorch_tpu/deploy.py``. ``torch.export`` traces the eval
functions, with the model's weights baked into each program, into one zip
that a serving host runs with torch and this package's kernel operators
(``ops/custom.py``) alone: no model classes, no checkpoint loading, no graph
code in Python. The reference has no such artifact (it ships the whole Python
package and a torch checkpoint, main.py:121-132).

Shape contract, as in the JAX package: each entry takes any batch (a
``torch.export.Dim`` on axis 0) and one static clip length (the streamable
padding is derived from the shape, ``ops/pad.py``), so each served length is
an entry of its own. Entries are exported on the model's device and stored on
the CPU; :meth:`DeployedCodec.load` moves them to the serving device. One
artifact serves on the CPU and on a card (``platforms``: ``cpu``, ``cuda``).

Kernels: the exported graphs hold kernels K1 (the RVQ cascade), K2 (the LSTM
recurrence) and K3 (the fused resblock, for ``weight_norm``/``none`` models)
as ``encodec::*`` nodes, traced on any device. Run on a card, each node
launches its CUDA kernel; on the CPU it runs the kernel's plain version. The
JAX package's artifacts run XLA ops there instead: its Pallas gates refuse a
symbolic batch (``encodec_pytorch_tpu/deploy.py``'s export, its
``tests/test_deploy.py::test_pallas_gates_refuse_symbolic_dims``).

Segmented (48 kHz-style) models work through the same entry kinds:
``encode`` returns a tuple of per-segment codes ``[B, K, Tf_i]`` (ragged: the
last segment is usually shorter), plus a tuple of ``[B, 1]`` scales when the
model normalizes, and ``decode`` replays the triangular overlap-add inside the
program. They run segment-major by default (``EncodecModel.encode_segmajor``
and ``decode_segmajor``).

Weights: the model's own, raw or folded (``prepare.fold_weight_norm``: fewer
ops a call, the same bits). Each entry holds only the parameters and buffers
its graph reads (the encoder's or the decoder's, and the first ``n_q``
codebooks). Int8 twins are refused: baking them would serve dense f32 after a
dequantization in every call, and the int8 kernel entries have no operator.

The artifacts are not interchangeable with the JAX package's: its zip holds
serialized StableHLO (``.shlo``), this one ``torch.export.save`` archives
(``.pt2``, stored without a second deflate). The meta rows are the same.
"""

import io
import json
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import lengthpad
from .ops import custom  # noqa: F401  (registers the encodec::* operators the programs call)

FORMAT_VERSION = 1
_META_NAME = 'meta.json'
_PLATFORMS = ('cpu', 'cuda')
_KINDS = ('encode', 'decode', 'roundtrip')


# ----------------------------------------------------------------- export


def _n_frames(model, length: int) -> int:
    """Number of segments ``model.encode`` makes of a clip of ``length``."""
    if model.segment_length is None:
        return 1
    return len(range(0, length, model.segment_stride))


def _segmajor_default(model) -> bool:
    """Segmented models serve segment-major by default, as the JAX builders do."""
    return model.segment is not None


def _encode_fn(model, segmajor: bool) -> Callable:
    encode = model.encode_segmajor if segmajor else model.encode

    def f(x):
        frames = encode(x)
        codes = tuple(c for c, _ in frames)
        if model.normalize:
            return codes, tuple(s for _, s in frames)
        return codes
    return f


def _decode_fn(model, out_length: int, segmajor: bool) -> Callable:
    decode = model.decode_segmajor if segmajor else model.decode
    if model.normalize:
        def f(codes, scales):
            return decode(list(zip(codes, scales)))[:, :, :out_length]
    else:
        def f(codes):
            return decode([(c, None) for c in codes])[:, :, :out_length]
    return f


def _roundtrip_fn(model, segmajor: bool) -> Callable:
    if not segmajor:
        return lambda x: model(x)

    def f(x):
        return model.decode_segmajor(model.encode_segmajor(x))[:, :, :x.shape[-1]]
    return f


class _Program(nn.Module):
    """``fn`` over ``model``'s weights, as one module for ``torch.export``."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(model, fn: Callable, args: tuple, dynamic_shapes: tuple):
    """``fn`` exported under ``no_grad``, holding only the weights it reads,
    stored on the CPU."""
    from torch.export.graph_signature import ExportGraphSignature, InputKind
    from torch.export.passes import move_to_device_pass
    with torch.no_grad():
        # forward's *args is one input: its dims nest one level deeper
        ep = torch.export.export(_Program(model, fn), args, dynamic_shapes=(dynamic_shapes,))
    gm = ep.graph_module
    placeholders = [n for n in gm.graph.nodes if n.op == 'placeholder']
    state, keep = dict(ep.state_dict), []
    for spec, node in zip(ep.graph_signature.input_specs, placeholders):
        if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER) and not node.users:
            gm.graph.erase_node(node)
            state.pop(spec.target)
        else:
            keep.append(spec)
    gm.recompile()
    ep = ep._update(gm, ExportGraphSignature(keep, ep.graph_signature.output_specs),
                    state_dict=state)
    return move_to_device_pass(ep, 'cpu')


def export_entries(model, lengths: Sequence[int], bandwidths: Optional[Sequence[float]] = None,
                   kinds: Sequence[str] = _KINDS, segment_major: Optional[bool] = None
                   ) -> Tuple[Dict[str, torch.export.ExportedProgram], List[dict]]:
    """Export encode/decode/roundtrip programs for every (bandwidth, length).

    Returns ``(exported, entries)``: name → ``ExportedProgram`` and the
    matching meta rows. Each program is traced on the model's device with its
    weights baked in, so dropping ``roundtrip`` from ``kinds`` (the loader
    composes encode∘decode instead) makes the artifact smaller.
    """
    bad_kinds = set(kinds) - set(_KINDS)
    if bad_kinds:
        raise ValueError(f'unknown kinds {sorted(bad_kinds)}')
    if any(getattr(m, 'int8', False) for m in model.modules()):
        raise ValueError('deploy: int8 weights are not supported (baking them would serve '
                         'dense f32); export the folded or raw model')
    if segment_major is None:
        segment_major = _segmajor_default(model)
    if bandwidths is None:
        bandwidths = [model.bandwidth if model.bandwidth is not None
                      else model.target_bandwidths[-1]]
    device = model.device
    restore_bw = model.bandwidth
    batch = torch.export.Dim('batch', min=1)
    exported: Dict[str, torch.export.ExportedProgram] = {}
    entries: List[dict] = []
    # bandwidths past the model's stages give the same n_q, so the same programs
    traced: Dict[tuple, torch.export.ExportedProgram] = {}

    def export(kind, n_q, length, fn, args, dims):
        if (kind, n_q, length) not in traced:
            traced[kind, n_q, length] = _export(model, fn, args, dims)
        return traced[kind, n_q, length]

    try:
        for bw in bandwidths:
            model.set_target_bandwidth(bw)
            for length in lengths:
                n_frames = _n_frames(model, length)
                encode = _encode_fn(model, segment_major)
                with torch.no_grad():
                    out = encode(torch.zeros(1, model.channels, length, device=device))
                codes = out[0] if model.normalize else out
                frame_tfs = [int(c.shape[-1]) for c in codes]
                # K from the encode's output, not the bandwidth policy, which is
                # unclamped (a model with fewer stages slices them)
                n_q = int(codes[0].shape[1])
                common = {'bandwidth': bw, 'length': length, 'n_q': n_q,
                          'n_frames': n_frames, 'frame_tfs': frame_tfs,
                          'normalize': model.normalize}
                x = torch.zeros(2, model.channels, length, device=device)
                if 'encode' in kinds:
                    name = f'encode_bw{bw:g}_t{length}'
                    exported[name] = export('encode', n_q, length, encode, (x,),
                                            ({0: batch},))
                    entries.append({'name': name, 'kind': 'encode', **common})
                if 'decode' in kinds:
                    name = f'decode_bw{bw:g}_t{length}'
                    args = (tuple(torch.zeros(2, n_q, tf, dtype=torch.int32, device=device)
                                  for tf in frame_tfs),)
                    if model.normalize:
                        args += (tuple(torch.ones(2, 1, device=device) for _ in frame_tfs),)
                    dims = tuple(tuple({0: batch} for _ in frame_tfs) for _ in args)
                    exported[name] = export('decode', n_q, length,
                                            _decode_fn(model, length, segment_major), args,
                                            dims)
                    entries.append({'name': name, 'kind': 'decode', **common})
                if 'roundtrip' in kinds:
                    name = f'roundtrip_bw{bw:g}_t{length}'
                    exported[name] = export('roundtrip', n_q, length,
                                            _roundtrip_fn(model, segment_major), (x,),
                                            ({0: batch},))
                    entries.append({'name': name, 'kind': 'roundtrip', **common})
    finally:
        model.bandwidth = restore_bw
    return exported, entries


def save_artifact(path, model, lengths: Sequence[int],
                  bandwidths: Optional[Sequence[float]] = None,
                  platforms: Sequence[str] = _PLATFORMS, kinds: Sequence[str] = _KINDS,
                  segment_major: Optional[bool] = None) -> dict:
    """Export and write a deployment zip. Returns the meta dict."""
    bad = set(platforms) - set(_PLATFORMS)
    if bad:
        raise ValueError(f'unknown platforms {sorted(bad)}; the programs run on {_PLATFORMS}')
    exported, entries = export_entries(model, lengths, bandwidths, kinds,
                                       segment_major=segment_major)
    meta = {
        'format_version': FORMAT_VERSION,
        'model_name': model.name,
        'sample_rate': model.sample_rate,
        'channels': model.channels,
        'frame_rate': model.frame_rate,
        'normalize': model.normalize,
        'segment': model.segment,
        'platforms': list(platforms),
        'entries': entries,
        # the serving-side length-bucketing gates (serve.CodecServer), as
        # LiveCodec.length_pad_{exact,tail_exact,min_samples} give them
        'causal': bool(model.encoder.causal),
        'pad_mode': model.encoder.pad_mode,
        'decoder_pad_mode': model.decoder.pad_mode,
        'hop_length': int(model.encoder.hop_length),
        'length_pad_min_samples': lengthpad.pad_min_samples(model),
    }
    with zipfile.ZipFile(path, 'w', zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_META_NAME, json.dumps(meta, indent=1))
        blobs: Dict[int, bytes] = {}
        for name, ep in exported.items():
            if id(ep) not in blobs:
                blob = io.BytesIO()
                torch.export.save(ep, blob)
                blobs[id(ep)] = blob.getvalue()
            zf.writestr(zipfile.ZipInfo(name + '.pt2'), blobs[id(ep)],
                        compress_type=zipfile.ZIP_STORED)
    return meta


# ----------------------------------------------------------------- serve


class DeployedCodec:
    """Loader and runner of a deployment zip. It needs torch and the kernel
    operators (``ops/custom.py``), never the model code: the graphs and the
    weights live in the artifact."""

    def __init__(self, meta: dict, programs: Dict[str, Callable], device: torch.device):
        self.meta = meta
        self.device = device
        self._programs = programs
        self._by_key: Dict[Tuple[str, float, int], dict] = {}
        for e in meta['entries']:
            self._by_key[(e['kind'], float(e['bandwidth']), e['length'])] = e

    @classmethod
    def load(cls, path, device='cuda') -> 'DeployedCodec':
        """Load the programs onto ``device`` (``cuda`` by default; without a
        card it refuses unless ``device='cpu'`` is given)."""
        from torch.export.passes import move_to_device_pass
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: DeployedCodec serves on the card; pass '
                               'device="cpu" to serve on the CPU')
        with zipfile.ZipFile(path) as zf:
            meta = json.loads(zf.read(_META_NAME))
            if meta.get('format_version') != FORMAT_VERSION:
                raise ValueError(f"artifact format {meta.get('format_version')} != "
                                 f'{FORMAT_VERSION}')
            programs, loaded = {}, {}
            for e in meta['entries']:
                blob = zf.read(e['name'] + '.pt2')
                if blob not in loaded:             # entries of one program share it
                    ep = torch.export.load(io.BytesIO(blob))
                    if device.type != 'cpu':
                        ep = move_to_device_pass(ep, device)
                    loaded[blob] = ep.module()
                programs[e['name']] = loaded[blob]
        return cls(meta, programs, device)

    # -- entry selection

    @property
    def lengths(self) -> List[int]:
        return sorted({e['length'] for e in self.meta['entries']})

    @property
    def bandwidths(self) -> List[float]:
        return sorted({float(e['bandwidth']) for e in self.meta['entries']})

    # -- the serving-side length-bucketing gates (serve.CodecServer), the
    # contract of LiveCodec; a server's length_buckets must be lengths the
    # artifact serves

    @property
    def length_pad_tail_exact(self) -> bool:
        m = self.meta
        return (lengthpad.tail_exact_gate(m.get('causal', False), m.get('normalize', True),
                                          m.get('segment'))
                and m.get('length_pad_min_samples', -1) >= 0 and 'hop_length' in m)

    @property
    def length_pad_exact(self) -> bool:
        m = self.meta
        return (self.length_pad_tail_exact and m.get('pad_mode') == 'constant'
                and m.get('decoder_pad_mode') == 'constant')

    @property
    def hop_length(self) -> int:
        return int(self.meta['hop_length'])

    @property
    def length_pad_min_samples(self) -> int:
        return int(self.meta.get('length_pad_min_samples', -1))

    def _entry(self, kind: str, length: int, bandwidth: Optional[float]) -> dict:
        bw = float(bandwidth) if bandwidth is not None else self.bandwidths[-1]
        e = self._by_key.get((kind, bw, length))
        if e is None:
            raise KeyError(f'no {kind} entry for length={length} bandwidth={bw:g}; artifact '
                           f'serves lengths {self.lengths} × bandwidths {self.bandwidths}')
        return e

    def _run(self, e: dict, *args):
        with torch.no_grad():
            return self._programs[e['name']](*args)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- calls (x: [B, C, T] float32; codes: tuple of [B, K, Tf_i] int32)

    def encode(self, x, bandwidth: Optional[float] = None):
        """→ per-frame codes ``([B, K, Tf_i], ...)``, and a matching scales
        tuple ``([B, 1], ...)`` if the model normalizes."""
        x = self._tensor(x)
        return self._run(self._entry('encode', x.shape[-1], bandwidth), x)

    def decode(self, codes, scales=None, bandwidth: Optional[float] = None,
               length: Optional[int] = None) -> torch.Tensor:
        """Codes (and scales, for a normalizing model) → wav ``[B, C, T]``."""
        codes = tuple(self._tensor(c, torch.int32) for c in codes)
        if length is None:
            shape_key = (len(codes), int(codes[0].shape[-2]), [int(c.shape[-1]) for c in codes])
            matches = [e for e in self.meta['entries']
                       if e['kind'] == 'decode'
                       and (e['n_frames'], e['n_q'], e['frame_tfs']) == shape_key
                       and (bandwidth is None or float(e['bandwidth']) == float(bandwidth))]
            if len(matches) != 1:
                raise KeyError(f'codes shapes {[tuple(c.shape) for c in codes]} match '
                               f'{len(matches)} decode entries; pass length= (and '
                               'bandwidth=) to disambiguate')
            e = matches[0]
        else:
            e = self._entry('decode', length, bandwidth)
        if e['normalize']:
            if scales is None:
                raise ValueError('this artifact normalizes: pass scales')
            return self._run(e, codes, tuple(self._tensor(s) for s in scales))
        return self._run(e, codes)

    def roundtrip(self, x, bandwidth: Optional[float] = None) -> torch.Tensor:
        """Encode and decode in one program, or, for an artifact saved without
        ``roundtrip`` entries, the encode∘decode composition (the same math,
        one more call)."""
        x = self._tensor(x)
        try:
            e = self._entry('roundtrip', x.shape[-1], bandwidth)
        except KeyError:
            out = self.encode(x, bandwidth)
            codes, scales = out if isinstance(out[0], (tuple, list)) else (out, None)
            return self.decode(codes, scales, bandwidth=bandwidth, length=x.shape[-1])
        return self._run(e, x)
