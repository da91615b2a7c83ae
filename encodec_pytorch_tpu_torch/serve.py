"""Serving runtime: dynamic micro-batching over one device-owning worker, and
a multiplexer of live chunked streams.

Port of ``encodec_pytorch_tpu/serve.py``:

- :class:`LiveCodec` — encode/decode/roundtrip over a live ``EncodecModel``
  (the port's model holds its weights). Each call is the model's eval path
  under ``torch.no_grad`` with the bandwidth set for that call under the
  codec's lock; the JAX package's per-(kind, bandwidth, length) jit cache has
  no counterpart. A segmented model (the 48 kHz family) runs segment-major
  by default (``EncodecModel.encode_segmajor``/``decode_segmajor``: the full
  segments of a batch in one call), and a normalizing one carries a scale a
  frame beside its codes.
- :class:`CodecServer` — a thread-safe front over a LiveCodec (or a
  ``deploy.DeployedCodec``): callers block on
  ``roundtrip``/``encode``/``decode`` (or get a Future from ``submit``); one
  worker thread owns the device, coalesces compatible queued requests (same
  kind, bandwidth and shape, after optional length bucketing) into one batch,
  pads the batch to a bucket size by repeating the last item, dispatches, and
  fans results back out as numpy arrays.
- :class:`StreamingServer` and :class:`StreamSession` — up to ``max_streams``
  concurrent chunked streams through one batched step a tick (the streaming
  codec of ``streaming.py``: kernels K3, K2 with a carried state, and K1 on
  CUDA), with an active-slot mask that keeps idle slots' state frozen. Every
  state tensor has the batch on axis 0, so the JAX package's batch-axis
  discovery (``_batch_axes``) is not needed.

Everything runs on ``device``, ``cuda`` by default; without a card the servers
refuse unless the caller passes ``device='cpu'``. ``LiveCodec(weights='fold')``
serves a weight-norm-folded copy of the model (``prepare.py``; bit-identical
results), and ``LiveCodec(weights='int8')`` its int8 weight-only twin
(``prepare.prepare_for_inference``): the weights stay int8 on the device and
each call dequantizes them in f32, even on a bf16 model, whose layers then
cast, as the JAX ``LiveCodec`` dequantizes inside its programs; on CUDA the
blocks and the LSTM read the int8 weights in kernels K3 and K2. A
``CodecServer`` over either serves the same; a ``StreamingServer`` takes the
folded or int8 model itself (``prepare.quantize_weights``). A ``CodecServer``
also serves a deployed artifact (``deploy.DeployedCodec``, loaded by the
caller with ``DeployedCodec.load(path)``), which has LiveCodec's interface.
The streaming server takes causal, unnormalized, unsegmented models only
(``streaming.py``), as the JAX package's does.
"""

import collections
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .lengthpad import exact_gate, pad_min_samples, tail_exact_gate
from .prepare import WEIGHTS, prepare_for_inference
from .streaming import StreamingCodec

_KINDS = ('encode', 'decode', 'roundtrip')


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the servers run on the card; pass device="cpu" '
                           'to serve on the CPU')
    return device


def _check_model_device(model, device: torch.device) -> None:
    have = model.device
    if have.type != device.type or (device.index is not None and have.index != device.index):
        raise ValueError(f'the model is on {have}, not {device}: move it there first')


def _flatten(tree) -> Tuple[list, Any]:
    """(leaves, structure) of nested tuples of arrays."""
    if isinstance(tree, (tuple, list)):
        leaves, structure = [], []
        for t in tree:
            sub, s = _flatten(t)
            leaves += sub
            structure.append(s)
        return leaves, tuple(structure)
    return [tree], None


def _unflatten(structure, leaves):
    it = iter(leaves)

    def build(s):
        return next(it) if s is None else tuple(build(c) for c in s)
    return build(structure)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class LiveCodec:
    """Encode, decode and roundtrip over a live model, with a concrete default
    bandwidth. Thread-safe: the bandwidth is set and used under one lock.

    ``weights``: ``'raw'`` serves ``model`` itself; ``'fold'`` and ``'int8'``
    its twin from ``prepare.prepare_for_inference`` (weight norm folded; then
    int8 weight-only, dequantized in f32 each call). ``segment_major``: None
    picks segment-major batching for segmented models (the JAX package's
    default); False keeps the per-segment loop."""

    def __init__(self, model, default_bandwidth: Optional[float] = None, *,
                 weights: str = 'raw', device='cuda', segment_major: Optional[bool] = None):
        if weights != 'raw' and weights not in WEIGHTS:
            raise ValueError(f"weights must be 'raw', 'fold' or 'int8', got {weights!r}")
        self.device = _resolve_device(device)
        _check_model_device(model, self.device)
        if weights != 'raw':
            model = prepare_for_inference(model, weights)
        self.model = model
        self.segment_major = (model.segment is not None if segment_major is None
                              else segment_major)
        # snapshot a CONCRETE default: requests with bandwidth=None must not
        # depend on what earlier requests set the (shared, mutable) model to
        self.default_bandwidth = (default_bandwidth if default_bandwidth is not None
                                  else model.bandwidth if model.bandwidth is not None
                                  else model.target_bandwidths[-1])
        self._lock = threading.Lock()
        self._pad_min: Optional[int] = None

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    def _call(self, bandwidth: Optional[float], fn):
        with self._lock:
            self.model.set_target_bandwidth(bandwidth if bandwidth is not None
                                            else self.default_bandwidth)
            return fn()

    def _encode(self, x):
        return (self.model.encode_segmajor if self.segment_major else self.model.encode)(x)

    def _decode(self, frames):
        return (self.model.decode_segmajor if self.segment_major else self.model.decode)(frames)

    def encode(self, x, bandwidth: Optional[float] = None):
        """x ``[B, C, T]`` → per-frame codes ``([B, K, T'], ...)``; for a
        normalizing model the pair (codes, per-frame scales ``([B, 1], ...)``)."""
        x = self._tensor(x)
        frames = self._call(bandwidth, lambda: self._encode(x))
        codes = tuple(c for c, _ in frames)
        return (codes, tuple(s for _, s in frames)) if self.model.normalize else codes

    def decode(self, codes, scales=None, bandwidth: Optional[float] = None,
               length: Optional[int] = None) -> torch.Tensor:
        """Per-frame codes (and, for a normalizing model, scales) → wav
        ``[B, C, T]``, cut to ``length`` when given."""
        if self.model.normalize:
            if scales is None:
                raise ValueError('this model normalizes: pass scales')
            scales = [self._tensor(s) for s in scales]
        elif scales is not None:
            raise ValueError('this model does not normalize: pass no scales')
        else:
            scales = [None] * len(codes)
        frames = [(self._tensor(c, torch.int32), s) for c, s in zip(codes, scales)]
        wav = self._call(bandwidth, lambda: self._decode(frames))
        return wav if length is None else wav[..., :length]

    def roundtrip(self, x, bandwidth: Optional[float] = None) -> torch.Tensor:
        x = self._tensor(x)
        return self._call(bandwidth,
                          lambda: self._decode(self._encode(x))[:, :, :x.shape[-1]])

    @property
    def length_pad_exact(self) -> bool:
        """True when right-zero-padding the time axis cannot change any output
        value before the pad point: causal, non-normalizing, single-frame
        models with ``pad_mode='constant'`` (see ``lengthpad.py``)."""
        m = self.model
        return exact_gate(m.encoder.causal, m.normalize, m.segment,
                          m.encoder.pad_mode, m.decoder.pad_mode)

    @property
    def length_pad_tail_exact(self) -> bool:
        """True when right-zero-padding can change at most the FINAL frame of
        codes (and so the final hop of audio): causal, non-normalizing,
        single-frame models of any pad mode, for clips of at least
        :attr:`length_pad_min_samples`."""
        m = self.model
        return tail_exact_gate(m.encoder.causal, m.normalize, m.segment)

    @property
    def hop_length(self) -> int:
        return self.model.encoder.hop_length

    @property
    def length_pad_min_samples(self) -> int:
        """Shortest clip for which the reflect-pad tail-exactness holds: the
        streaming codec's minimum first chunk (2240 samples at the 24 kHz
        architecture); 0 for constant-pad models."""
        if self._pad_min is None:
            self._pad_min = pad_min_samples(self.model)
        return self._pad_min


class _Request:
    __slots__ = ('kind', 'args', 'bandwidth', 'length', 'future', 't0', 'batch_key',
                 'out_tail')

    def __init__(self, kind, args, bandwidth, length, out_tail=None):
        self.kind = kind
        self.args = args          # nested tuples; every array leaf is ONE item
        self.bandwidth = bandwidth
        self.length = length
        self.out_tail = out_tail  # slice every output leaf to [..., :n]
        self.future: Future = Future()
        self.t0 = time.monotonic()
        leaves, structure = _flatten(args)
        shapes = tuple((np.shape(l), np.asarray(l).dtype.str) for l in leaves)
        self.batch_key = (kind, bandwidth, length, structure, shapes)


class CodecServer:
    """Dynamic micro-batching server over a :class:`LiveCodec` or a
    ``deploy.DeployedCodec``.

    - ``max_batch``: hard cap on items per dispatch.
    - ``max_wait_ms``: after the first request of a batch arrives, how long to
      hold the dispatch open for more compatible requests.
    - ``bucket_sizes``: batches are padded (by repeating the last item) up to
      the next bucket, so the device sees a bounded set of batch shapes;
      results for pad rows are dropped.
    - ``length_buckets``: optional sorted sample lengths. Wav and codes inputs
      are right-zero-padded on the time axis up to the next bucket before
      keying, so mixed-length traffic coalesces into one batch; results are
      sliced back to the true length. Requires a backend whose padding is
      exact (``length_pad_exact``, constant-pad causal models) or tail-exact
      (``length_pad_tail_exact``, reflect-pad causal models: at most the final
      code frame and final hop of audio differ from a direct call). Requests
      longer than the largest bucket, shorter than the backend's
      ``length_pad_min_samples``, or decode requests with an explicit
      ``length`` keep exact-shape keying.
    """

    def __init__(self, backend, *, max_batch: int = 8, max_wait_ms: float = 2.0,
                 bucket_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 length_buckets: Optional[Sequence[int]] = None):
        if isinstance(backend, (str, os.PathLike)):
            raise TypeError(f'CodecServer takes a backend, not the path {str(backend)!r}: '
                            'load an artifact with deploy.DeployedCodec.load(path) and '
                            'serve that')
        self.backend = backend
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.buckets = sorted(b for b in bucket_sizes if b <= max_batch) or [max_batch]
        self.length_buckets = sorted(length_buckets) if length_buckets else None
        if self.length_buckets:
            exact = getattr(backend, 'length_pad_exact', False)
            if not (exact or getattr(backend, 'length_pad_tail_exact', False)):
                raise ValueError(
                    'length_buckets requires a backend whose time-axis padding is exact or '
                    'tail-exact (causal, non-normalizing, single-frame models — '
                    'backend.length_pad_exact / length_pad_tail_exact); '
                    f'{type(backend).__name__} does not qualify')
            self._hop = int(backend.hop_length)
            # below this, the short-input reflect guard makes padding non-exact:
            # such requests keep exact-shape keying
            self._min_len = int(getattr(backend, 'length_pad_min_samples', 0))
            if self._min_len < 0 and not exact:
                raise ValueError(
                    'length_buckets: backend reports length_pad_min_samples < 0 '
                    '(short-input exactness horizon unknown) on a tail-exact-only backend; '
                    'refusing length bucketing')
        self._queue: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._stats = {'requests': 0, 'batches': 0, 'batched_items': 0, 'padded_items': 0}
        self._latencies: collections.deque = collections.deque(maxlen=1000)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> 'CodecServer':
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._worker, name='codec-server',
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ submit

    def _length_bucket(self, kind: str, args, length: Optional[int]):
        """(padded args, out_tail): right-zero-pad the time axis to the next
        length bucket so mixed-length requests share a batch key; out_tail is
        how much of each output leaf's last axis is real."""
        if not self.length_buckets or length is not None:
            return args, None
        if kind in ('roundtrip', 'encode'):
            x = np.asarray(args)
            T = x.shape[-1]
            b = next((b for b in self.length_buckets if b >= T), None)
            if b is None or T < self._min_len:
                return args, None
            pad = [(0, 0)] * (x.ndim - 1) + [(0, b - T)]
            frames = -(-T // self._hop)
            return np.pad(x, pad), frames if kind == 'encode' else T
        # decode: args = (codes_tuple,), single-frame models only
        codes = args[0]
        if len(args) > 1 or len(codes) != 1:
            return args, None
        c = np.asarray(codes[0])
        Tc = c.shape[-1]
        fb = next((-(-b // self._hop) for b in self.length_buckets
                   if -(-b // self._hop) >= Tc), None)
        if fb is None or Tc * self._hop < self._min_len:
            return args, None
        padded = np.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, fb - Tc)])
        return ((padded,),), Tc * self._hop

    def submit(self, kind: str, args, bandwidth: Optional[float] = None,
               length: Optional[int] = None) -> Future:
        """Enqueue one item; the Future resolves to its un-batched result."""
        if kind not in _KINDS:
            raise ValueError(f'kind must be one of {_KINDS}')
        args, out_tail = self._length_bucket(kind, args, length)
        req = _Request(kind, args, bandwidth, length, out_tail)
        with self._cv:
            self._stats['requests'] += 1
            self._queue.append(req)
            self._cv.notify()
        return req.future

    def roundtrip(self, x, bandwidth: Optional[float] = None,
                  timeout: Optional[float] = None) -> np.ndarray:
        """x: ONE clip ``[C, T]`` → ``[C, T]``."""
        return self.submit('roundtrip', np.asarray(x), bandwidth).result(timeout)

    def encode(self, x, bandwidth: Optional[float] = None, timeout: Optional[float] = None):
        """x: ONE clip ``[C, T]`` → per-frame codes tuple ``([K, T'], ...)``
        (with the per-frame scales for a normalizing model, as
        :meth:`LiveCodec.encode`)."""
        return self.submit('encode', np.asarray(x), bandwidth).result(timeout)

    def decode(self, codes, scales=None, bandwidth: Optional[float] = None,
               length: Optional[int] = None, timeout: Optional[float] = None):
        """codes: ONE clip's per-frame tuple ``([K, T'], ...)`` (and scales
        ``([1], ...)`` for a normalizing model) → ``[C, T]``."""
        args = (tuple(codes), tuple(scales)) if scales is not None else (tuple(codes),)
        return self.submit('decode', args, bandwidth, length).result(timeout)

    def stats(self) -> dict:
        with self._cv:
            s = dict(self._stats)
            lats = sorted(self._latencies)
        if lats:
            s['latency_p50_ms'] = 1e3 * lats[len(lats) // 2]
            s['latency_p99_ms'] = 1e3 * lats[min(len(lats) - 1, int(len(lats) * 0.99))]
        s['mean_batch'] = s['batched_items'] / s['batches'] if s['batches'] else 0.0
        return s

    # ------------------------------------------------------------ worker

    def _take_batch(self) -> List[_Request]:
        """Block for the first request, then hold the dispatch open up to
        max_wait for more requests with the same batch key (FIFO order;
        incompatible requests stay queued)."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait(timeout=0.1)
            if self._stop and not self._queue:
                return []
            head = self._queue.popleft()
            batch = [head]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                rest = []
                for r in self._queue:
                    if len(batch) < self.max_batch and r.batch_key == head.batch_key:
                        batch.append(r)
                    else:
                        rest.append(r)
                self._queue = collections.deque(rest)
                if len(batch) >= self.max_batch:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop:
                    break
                self._cv.wait(timeout=remaining)
            return batch

    def _dispatch(self, batch: List[_Request]):
        n = len(batch)
        padded = max(next((b for b in self.buckets if b >= n), self.max_batch), n)
        # stack items on a new axis 0; pad by repeating the last item
        rows = [_flatten(r.args)[0] for r in batch]
        rows += [rows[-1]] * (padded - n)
        structure = _flatten(batch[0].args)[1]
        stacked = _unflatten(structure, [np.stack([row[i] for row in rows])
                                         for i in range(len(rows[0]))])
        head = batch[0]
        if head.kind == 'roundtrip':
            out = self.backend.roundtrip(stacked, bandwidth=head.bandwidth)
        elif head.kind == 'encode':
            out = self.backend.encode(stacked, bandwidth=head.bandwidth)
        else:
            scales = stacked[1] if len(stacked) > 1 else None
            out = self.backend.decode(stacked[0], scales, bandwidth=head.bandwidth,
                                      length=head.length)
        out = _tree_map(_to_numpy, out)

        now = time.monotonic()
        with self._cv:
            self._stats['batches'] += 1
            self._stats['batched_items'] += n
            self._stats['padded_items'] += padded - n
            for r in batch:
                self._latencies.append(now - r.t0)
        for i, r in enumerate(batch):
            res = _tree_map(lambda a: a[i], out)
            if r.out_tail is not None:   # length-bucketed: drop the pad tail
                res = _tree_map(lambda a, n=r.out_tail: a[..., :n], res)
            r.future.set_result(res)

    def _worker(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — fan the error out
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)


# ===================================================================== live
# streaming multiplexer


def _mask_select(mask: torch.Tensor, new, old):
    """``where(mask)`` on axis 0 of every state tensor: inactive slots keep
    their old state."""
    if isinstance(new, dict):
        return {k: _mask_select(mask, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return tuple(_mask_select(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask.view(-1, *[1] * (new.dim() - 1)), new, old)


def _splice_slot(storage, state1, slot: int) -> None:
    """Write a B = 1 state into row ``slot`` of every state tensor, in place."""
    if isinstance(storage, dict):
        for k in storage:
            _splice_slot(storage[k], state1[k], slot)
    elif isinstance(storage, tuple):
        for s, s1 in zip(storage, state1):
            _splice_slot(s, s1, slot)
    else:
        storage[slot] = state1[0]


class StreamSession:
    """One live stream inside a :class:`StreamingServer`. ``process`` blocks
    until the chunk's decoded audio is ready; chunks after the first must be
    exactly ``server.chunk_samples`` long."""

    def __init__(self, server: 'StreamingServer', slot: int):
        self._server = server
        self.slot = slot
        self.started = False
        self.closed = False

    def process(self, wav_chunk, timeout: Optional[float] = None, with_codes: bool = False):
        """wav_chunk ``[C, T]`` → decoded ``[C, T]`` (equal to the offline
        model on the concatenated stream), or with ``with_codes`` the pair
        (decoded, codes ``[K, T/hop]``). First chunk: T ≥
        ``server.min_first_chunk_samples``, a multiple of the hop."""
        if self.closed:
            raise RuntimeError('stream is closed')
        wav, codes = self._server._process(self, np.asarray(wav_chunk, np.float32),
                                           timeout=timeout)
        return (wav, codes) if with_codes else wav

    def close(self):
        if not self.closed:
            self.closed = True
            self._server._release(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamingServer:
    """Multiplexes up to ``max_streams`` concurrent chunked streams through one
    batched step a tick (encode, quantize, dequantize and decode with carried
    conv and LSTM state; ``streaming.py``'s math, so each stream's output
    equals it running alone).

    Every slot lives at a fixed row of a batched state; each tick runs ALL
    slots and an active mask keeps the state of idle slots frozen. Joins run
    their (longer) first chunk at B = 1 with ``first=True``, then the fresh
    state is spliced into the slot.

    Constraints inherited from ``streaming.py``: causal, unnormalized models;
    steady chunks exactly ``chunk_hops`` latent frames (320 samples each at
    24 kHz); one bandwidth per server.
    """

    def __init__(self, model, *, max_streams: int = 8, chunk_hops: int = 1,
                 max_wait_ms: float = 2.0, bandwidth: Optional[float] = None, device='cuda'):
        if max_streams < 2:
            raise ValueError('max_streams must be >= 2 (a 1-slot server is '
                             'StreamingCodec itself)')
        self.device = _resolve_device(device)
        _check_model_device(model, self.device)
        if bandwidth is not None:
            model.set_target_bandwidth(bandwidth)
        self.model = model
        self.codec = StreamingCodec(model)
        self.max_streams = max_streams
        self.chunk_samples = chunk_hops * self.codec.hop
        self.max_wait = max_wait_ms / 1e3
        self._enc_state, self._dec_state = self.codec.init_state(max_streams)

        self._free = list(range(max_streams - 1, -1, -1))
        self._pending: Dict[int, Tuple[np.ndarray, Future, StreamSession]] = {}
        self._sessions: Dict[int, StreamSession] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._stats = {'chunks': 0, 'ticks': 0, 'joins': 0, 'resets': 0}
        self._tick_s: collections.deque = collections.deque(maxlen=1000)

    @property
    def min_first_chunk_samples(self) -> int:
        return self.codec.min_first_chunk_samples

    # ---------------------------------------------------------- lifecycle

    def start(self) -> 'StreamingServer':
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._worker, name='streaming-server',
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        with self._cv:
            self._stop = True
            # fail chunks still waiting: their callers block on futures that no
            # tick will serve
            self._fail_pending(RuntimeError('streaming server stopped'))
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def stats(self) -> dict:
        """Counters, active streams, and the batched step's host-clock time
        (``tick_ms_p50``/``p99``, the mux call through the copy of its output
        to the host)."""
        with self._cv:
            s = dict(self._stats)
            s['active_streams'] = self.max_streams - len(self._free)
            ticks = sorted(self._tick_s)
        if ticks:
            s['tick_ms_p50'] = 1e3 * ticks[len(ticks) // 2]
            s['tick_ms_p99'] = 1e3 * ticks[min(len(ticks) - 1, int(len(ticks) * 0.99))]
        return s

    # ---------------------------------------------------------- sessions

    def open_stream(self) -> StreamSession:
        with self._cv:
            if not self._free:
                raise RuntimeError(f'all {self.max_streams} stream slots are in use')
            slot = self._free.pop()
            session = StreamSession(self, slot)
            self._sessions[slot] = session
        return session

    def _release(self, session: StreamSession):
        with self._cv:
            dropped = self._pending.pop(session.slot, None)
            if dropped is not None and not dropped[1].done():
                dropped[1].set_exception(RuntimeError('stream closed with a chunk in flight'))
            if self._sessions.get(session.slot) is session:
                del self._sessions[session.slot]
                self._free.append(session.slot)

    def _process(self, session: StreamSession, chunk: np.ndarray, timeout: Optional[float]):
        if session.started and chunk.shape[-1] != self.chunk_samples:
            raise ValueError(f'steady chunks must be exactly {self.chunk_samples} samples, '
                             f'got {chunk.shape[-1]}')
        fut: Future = Future()
        with self._cv:
            if self._stop:
                raise RuntimeError('streaming server stopped')
            if session.slot in self._pending:
                raise RuntimeError('one in-flight chunk per stream (process() blocks)')
            self._pending[session.slot] = (chunk, fut, session)
            self._stats['chunks'] += 1
            self._cv.notify()
        return fut.result(timeout)

    def _fail_pending(self, err: Exception):
        for _chunk, fut, _sess in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()

    # ---------------------------------------------------------- the step

    @torch.no_grad()
    def _mux(self, enc_state, dec_state, x: torch.Tensor, mask: torch.Tensor):
        """One tick over every slot: (wav, codes ``[B, K, t]``, enc_state,
        dec_state), idle slots' state unchanged."""
        codec = self.codec
        emb, new_enc = codec.encoder.apply(enc_state, x)
        codes = codec.quantize(emb)                                  # [K, B, t]
        y, new_dec = codec.decoder.apply(dec_state, codec.dequantize(codes))
        return (y, codes.transpose(0, 1), _mask_select(mask, new_enc, enc_state),
                _mask_select(mask, new_dec, dec_state))

    def _first_chunk(self, slot: int, chunk: np.ndarray):
        enc1, dec1 = self.codec.init_state(1)
        x = torch.from_numpy(chunk[None]).to(self.device)
        wav, codes, enc1, dec1 = self.codec.roundtrip_chunk(enc1, dec1, x, first=True)
        _splice_slot(self._enc_state, enc1, slot)
        _splice_slot(self._dec_state, dec1, slot)
        return _to_numpy(wav[0]), _to_numpy(codes[0])

    def _worker(self):
        channels = self.model.channels
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    self._fail_pending(RuntimeError('streaming server stopped'))
                    return
                deadline = time.monotonic() + self.max_wait
                # hold the tick open briefly for more streams' chunks
                while len(self._pending) < self.max_streams - len(self._free):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop:
                        break
                    self._cv.wait(timeout=remaining)
                pending, self._pending = dict(self._pending), {}
                self._stats['ticks'] += 1

            firsts = {s: v for s, v in pending.items() if not v[2].started}
            steady = {s: v for s, v in pending.items() if v[2].started}

            for slot, (chunk, fut, sess) in firsts.items():
                try:
                    out = self._first_chunk(slot, chunk)
                    sess.started = True
                    with self._cv:
                        self._stats['joins'] += 1
                    fut.set_result(out)
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)

            if not steady:
                continue
            try:
                t0 = time.perf_counter()
                xs = np.zeros((self.max_streams, channels, self.chunk_samples), np.float32)
                mask = np.zeros((self.max_streams,), bool)
                for slot, (chunk, _f, _s) in steady.items():
                    xs[slot] = chunk
                    mask[slot] = True
                wav, codes, self._enc_state, self._dec_state = self._mux(
                    self._enc_state, self._dec_state, torch.from_numpy(xs).to(self.device),
                    torch.from_numpy(mask).to(self.device))
                wav, codes = _to_numpy(wav), _to_numpy(codes)
                with self._cv:
                    self._tick_s.append(time.perf_counter() - t0)
                for slot, (_c, fut, _s) in steady.items():
                    fut.set_result((wav[slot], codes[slot]))
            except Exception as e:  # noqa: BLE001
                # reset FIRST so callers waking on the error already see their
                # session closed and the slot pool rebuilt
                self._reset_after_failure(e)
                for _c, fut, _s in steady.values():
                    if not fut.done():
                        fut.set_exception(e)

    def _reset_after_failure(self, err: Exception):
        """A failed step may leave the carried state half-updated, so it is
        unusable. Recover the server: close every active stream (their carries
        are lost; callers see the error and must rejoin) and rebuild fresh slot
        state so new streams work."""
        self._enc_state, self._dec_state = self.codec.init_state(self.max_streams)
        with self._cv:
            for slot, sess in list(self._sessions.items()):
                sess.closed = True
                dropped = self._pending.pop(slot, None)
                if dropped is not None and not dropped[1].done():
                    dropped[1].set_exception(err)
                del self._sessions[slot]
                self._free.append(slot)
            self._stats['resets'] += 1
