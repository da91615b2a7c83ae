"""The on-device LM entropy codec: the LM step in torch and the CDF
quantization and range coder in kernel K6, one frame at a time.

Port of ``encodec_pytorch_tpu/bitstream/fused.py`` (``kv_init_state``,
``kv_lm_step``, ``bits_capacity``, ``FusedLmCoder``, ``StreamingLmEncoder``,
``StreamingLmDecoder``). The JAX package runs
a frame as one ``lax.scan`` program; here the T steps are a Python loop of
eager torch ops and K6 launches on the LM's device, and nothing inside the
loop waits for the device:

- encode knows every code up front, so it runs the LM steps teacher-forced,
  collects the pdfs of :data:`ENCODE_CHUNK` steps ``[chunk, K, card]`` in a
  reused buffer on the device and codes them in one K6 launch a chunk (the
  coder's state and bit cursor carry across launches; the last one
  flushes), then fetches the bits once; so a long frame holds one chunk's
  pdfs, not the whole frame's;
- decode launches K6 once a step; the step's decoded symbols stay on the
  device and are the next step's embedding indices (``1 + syms``), and the
  end-of-stream flag is fetched once, after the loop.

Encode and decode run the same step function on the same device, so both
see the same probabilities, bit for bit. The LM step (``kv_lm_step``) keeps
the projected keys and values of each layer in a fixed-size ring
``[L, past_context + 1, 2C]`` on the device, updated in place, so a step
projects only its own token. Slot ``t mod (past_context + 1)`` takes step
t's key and value before the attention; a slot never written holds the
projection of a zero input (the in-projection's bias), which is what the
reference's zero sentinel key contributes, and a mask row lets the query see
the written slots and one such slot until the sentinel leaves the context.

``FusedLmCoder(lm, kv_cache=False)`` steps the LM module itself instead
(``LMModel.forward`` on one step with its carried state, the step
``compress.LM.teacher_forced`` runs), as the JAX package's ``kv_cache=False``
codec steps ``LMModel.apply``; its streams are not interchangeable with the
projected-KV ones (other ops, other roundings of the probabilities), and no
``compress`` route selects it.

The streaming coder (``StreamingLmEncoder``/``StreamingLmDecoder``, the
semantics of the JAX package's ``make_fused_lm_stream_step``) codes one
frame of K codes a call with the LM and coder state carried across calls,
with no flush and no length prefix a frame. It runs ``kv_lm_step`` and K6 as
``FusedLmCoder`` does, on the same device, so a whole stream's bytes plus its
flush are ``FusedLmCoder.encode``'s of the same codes, byte for byte. The
decoder runs K6's stall mode: it stalls exactly when the next symbol's
renormalization needs bits that have not arrived, and a stalled frame leaves
the LM and coder state as they were, so ``pull_frame`` returns None and the
next call retries it. (The step writes one ring slot, before any attention
reads it; the retry writes the same key and value there, and the slot's old
entry is out of the context, so the write is idempotent.) Each call fetches
one small tensor from the device (the coder's state with the bytes or the
symbols): one host sync a frame. What goes the other way (the codes a push
takes from numpy, the bytes a decoder is fed) is staged in pinned memory and
copied without waiting for the device.

Bits are LSB-first (``np.packbits(..., bitorder='little')``), as the host
``BitPacker(bits=1)`` writes them. A decoder that reads past the stream's end
raises ``EOFError``, as the host path does.
"""

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..models.lm import LMModel
from ..models.transformer import create_sin_embedding
from ..ops import lm_coder_kernel as K6
from ..ops.lm_coder_kernel import bits_capacity

ENCODE_CHUNK = 256      # steps of pdfs an encode launch of K6 codes


def _upload(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` into ``dst`` without a host sync: a host tensor bound
    for the card goes through pinned memory, which the caching host
    allocator keeps until the copy has run."""
    if dst.is_cuda and not src.is_cuda:
        src = src.to(dst.dtype).pin_memory()
    dst.copy_(src, non_blocking=True)


class KvWeights:
    """An :class:`LMModel`'s parameters in the layout :func:`kv_lm_step`
    reads, on the LM's device: the embeddings ``[n_q, card + 1, C]``, the
    heads ``[n_q, C, card]`` and ``[n_q, 1, card]``, each layer's tensors,
    the additive attention masks ``[S + 1, S + 1]`` and a table of
    positional embeddings that grows as steps need it."""

    def __init__(self, lm: LMModel):
        tr = lm.transformer
        self.dim, self.heads, self.card = lm.dim, lm.num_heads, lm.card
        self.slots = lm.past_context + 1
        self.max_period = tr.max_period
        with torch.no_grad():
            self.emb = torch.stack([e.weight for e in lm.emb])
            self.head_w = torch.stack([lin.weight.t() for lin in lm.linears])
            self.head_b = torch.stack([lin.bias for lin in lm.linears])[:, None]
        self.device = self.emb.device
        self.norm_in = (tr.norm_in.weight, tr.norm_in.bias)
        self.layers = [layer for layer in tr.layers]
        S1 = self.slots
        j = torch.arange(S1, device=self.device)
        valid = (j[None, :] <= j[:, None]) | (j[None, :] == S1 - 1)
        self.masks = torch.zeros(S1, S1, device=self.device).masked_fill_(~valid, float('-inf'))
        self.k_range = torch.arange(lm.n_q, device=self.device)
        self._positions = torch.empty(0, self.dim, device=self.device)

    def position(self, offset: int) -> torch.Tensor:
        if offset >= self._positions.shape[0]:
            n = max(2 * self._positions.shape[0], offset + 1, 1024)
            self._positions = create_sin_embedding(n, 0, self.dim, self.max_period,
                                                   device=self.device)[0]
        return self._positions[offset]


KvState = tp.Tuple[torch.Tensor, int]


def kv_init_state(w: KvWeights) -> KvState:
    """(the key/value ring ``[L, S + 1, 2C]`` filled with each layer's
    key and value biases, offset 0)."""
    C = w.dim
    with torch.no_grad():
        ring = torch.stack([layer.self_attn.in_proj_bias[C:] for layer in w.layers])
        ring = ring[:, None, :].repeat(1, w.slots, 1)
    return ring, 0


def kv_lm_step(w: KvWeights, indices: torch.Tensor, state: KvState
               ) -> tp.Tuple[torch.Tensor, KvState]:
    """One LM step: ``indices [K]`` (1 + previous codes, 0 = missing) →
    (pdfs ``[K, card]`` float32, the next state). The ring is updated in
    place, so the state passed in is consumed."""
    ring, offset = state
    K = indices.shape[0]
    C, H, S1 = w.dim, w.heads, w.slots
    hd = C // H
    slot = offset % S1
    mask = w.masks[min(offset, S1 - 1)].expand(H, 1, S1)
    with torch.no_grad():
        x = w.emb[w.k_range[:K], indices].sum(0)
        x = F.layer_norm(x, (C,), *w.norm_in) + w.position(offset)
        for i, layer in enumerate(w.layers):
            attn = layer.self_attn
            qkv = F.linear(x, attn.in_proj_weight, attn.in_proj_bias)
            ring[i, slot].copy_(qkv[C:])
            keys = ring[i, :, :C].view(S1, H, hd).permute(1, 2, 0)     # [H, hd, S1]
            vals = ring[i, :, C:].view(S1, H, hd).transpose(0, 1)      # [H, S1, hd]
            scores = torch.baddbmm(mask, qkv[:C].view(H, 1, hd), keys, alpha=hd ** -0.5)
            out = torch.bmm(torch.softmax(scores, dim=-1), vals).view(C)
            out = F.linear(out, attn.out_proj.weight, attn.out_proj.bias)
            x = F.layer_norm(x + out, (C,), layer.norm1.weight, layer.norm1.bias)
            h = F.gelu(F.linear(x, layer.linear1.weight, layer.linear1.bias))
            h = F.linear(h, layer.linear2.weight, layer.linear2.bias)
            x = F.layer_norm(x + h, (C,), layer.norm2.weight, layer.norm2.bias)
        logits = torch.baddbmm(w.head_b[:K], x.expand(K, 1, C), w.head_w[:K])
        pdfs = torch.softmax(logits.view(K, w.card), dim=-1)
    return pdfs, (ring, offset + 1)


class FusedLmCoder:
    """bytes <-> codes ``[K, T]`` through the LM step and K6 on the LM's
    device (the plain coder on the CPU): the projected-KV step, or with
    ``kv_cache=False`` the LM module's own step."""

    def __init__(self, lm: LMModel, kv_cache: bool = True):
        self.lm, self.kv_cache = lm, kv_cache
        self.card = lm.card
        self.weights = KvWeights(lm) if kv_cache else None

    @property
    def device(self) -> torch.device:
        return self.lm.emb[0].weight.device

    def init_state(self):
        return kv_init_state(self.weights) if self.kv_cache else None

    def step(self, indices: torch.Tensor, state) -> tp.Tuple[torch.Tensor, tp.Any]:
        """``indices [K]`` (1 + the previous codes) → (pdfs ``[K, card]``, the
        next state)."""
        if self.kv_cache:
            return kv_lm_step(self.weights, indices, state)
        with torch.no_grad():
            probas, state = self.lm(indices[None, :, None], state)
        return probas[0, :, :, 0].t().contiguous(), state

    def encode(self, frame: np.ndarray) -> bytes:
        """codes ``[K, T]`` → the arithmetic-coded bytes."""
        frame = np.asarray(frame)
        K, T = frame.shape
        if frame.size and (frame.min() < 0 or frame.max() >= self.card):
            raise ValueError(f'codes outside 0..{self.card - 1}')
        dev = self.device
        inputs = np.zeros((T, K), np.int64)
        inputs[1:] = 1 + frame.T[:-1]
        syms = torch.from_numpy(np.ascontiguousarray(frame.T, np.int32)).to(dev)
        bits = torch.zeros(K6.stream_bytes(bits_capacity(K * T)), dtype=torch.uint8, device=dev)
        coder = self.encode_steps(torch.from_numpy(inputs).to(dev), syms, bits).cpu()
        if coder[K6.OVERFLOW]:
            raise RuntimeError('the stream outgrew its bit buffer, or a code was outside '
                               'the card')
        return bits[:K6.stream_bytes(int(coder[K6.BIT_POS]))].cpu().numpy().tobytes()

    def encode_steps(self, inputs: torch.Tensor, syms: torch.Tensor,
                     bits: torch.Tensor) -> torch.Tensor:
        """The device half of :meth:`encode`, with no host sync: the LM
        teacher-forced on ``inputs [T, K]`` (1 + the codes before each step),
        and a K6 launch every :data:`ENCODE_CHUNK` steps that codes those
        steps of ``syms [T, K]`` int32 into the zeroed ``bits``; the last one
        flushes. Returns the coder's state. The bytes do not depend on the
        chunk."""
        T, K = syms.shape
        chunk = ENCODE_CHUNK
        pdfs = torch.empty(min(chunk, T), K, self.card, device=self.device)
        state = self.init_state()
        coder = K6.init_state(self.device)
        for t0 in range(0, T, chunk):
            n = min(chunk, T - t0)
            for i in range(n):
                p, state = self.step(inputs[t0 + i], state)
                pdfs[i].copy_(p)
            K6.lm_coder(pdfs[:n], syms[t0:t0 + n], coder, bits, decode=False,
                        finish=t0 + n == T)
        return coder

    def decode(self, data: bytes, K: int, T: int) -> np.ndarray:
        """bytes → codes ``[K, T]`` int64; ``EOFError`` when the stream ends
        before T steps."""
        buf = np.zeros(K6.stream_bytes(bits_capacity(K * T)), np.uint8)
        raw = np.frombuffer(data, np.uint8)[:buf.size]
        buf[:raw.size] = raw
        syms, coder = self.decode_steps(torch.from_numpy(buf).to(self.device), 8 * len(data),
                                        K, T)
        if coder[K6.OVERRUN].item():
            raise EOFError("The stream ended sooner than expected.")
        return syms.t().cpu().numpy().astype(np.int64)

    def decode_steps(self, bits: torch.Tensor, n_bits_in: int, K: int, T: int
                     ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """The device half of :meth:`decode`, with no host sync: T steps of
        the LM and a K6 launch each, every step's symbols the next one's
        input. Returns (symbols ``[T, K]`` int32, the coder's state)."""
        dev = self.device
        syms = torch.zeros(T, K, dtype=torch.int32, device=dev)
        rows = syms.split(1)        # each step's [1, K] view, made once
        coder = K6.init_state(dev)
        state = self.init_state()
        indices = torch.zeros(K, dtype=torch.int64, device=dev)
        for t in range(T):
            if t:
                indices = syms[t - 1] + 1
            pdfs, state = self.step(indices, state)
            K6.lm_coder(pdfs[None], rows[t], coder, bits, decode=True, n_bits_in=n_bits_in)
        return syms, coder


class _StreamCoder:
    """The state a streaming encoder or decoder carries on the LM's device:
    the projected-KV step's weights and ring, the next step's input
    ``1 + codes`` ``[K]``, the coder's state and the symbols' buffer."""

    def __init__(self, lm: LMModel, K: int):
        if not 1 <= K <= lm.n_q:
            raise ValueError(f'K={K} codebooks, and the LM codes 1..{lm.n_q}')
        self.weights = KvWeights(lm)
        self.K, self.card = K, lm.card
        dev = self.device = self.weights.device
        self._lm_state = kv_init_state(self.weights)
        self._input = torch.zeros(K, dtype=torch.int64, device=dev)
        self._coder = K6.init_state(dev)
        self._syms = torch.zeros(1, K, dtype=torch.int32, device=dev)


class StreamingLmEncoder(_StreamCoder):
    """Push one frame of K codes at a time and get the bytes that are
    complete; :meth:`flush` ends the stream with the coder's last bits.

    The bit buffer on the device holds the partial byte carried from the
    frames before and one frame's bits; it is rebased after each frame (the
    whole bytes go to the host), so an unbounded stream never outgrows it."""

    def __init__(self, lm: LMModel, K: int):
        super().__init__(lm, K)
        self._cap = K6.stream_bytes(8 + bits_capacity(K))
        self._bits = torch.zeros(self._cap, dtype=torch.uint8, device=self.device)
        self._finished = False

    def _fetch(self) -> tp.Tuple[int, bytes, int]:
        """(bits written, the buffer's bytes, overflow) in one transfer."""
        host = torch.cat([self._coder.view(torch.uint8), self._bits]).cpu().numpy()
        state = host[:8 * K6.STATE_SIZE].view(np.int64)
        return int(state[K6.BIT_POS]), host[8 * K6.STATE_SIZE:].tobytes(), int(state[K6.OVERFLOW])

    def push_frame(self, codes_t) -> bytes:
        """codes ``[K]`` (numpy, or a tensor on the LM's device) → zero or
        more whole bytes of the stream."""
        if self._finished:
            raise RuntimeError('push_frame after flush(): flush emits the final coder state '
                               'and ends the stream')
        if isinstance(codes_t, torch.Tensor):
            codes = codes_t.reshape(1, -1)
        else:
            codes = torch.from_numpy(np.asarray(codes_t, np.int32).reshape(1, -1))
        if codes.shape[1] != self.K:
            raise ValueError(f'a frame has {self.K} codes, got {tuple(codes.shape[1:])}')
        _upload(self._syms, codes)
        pdfs, self._lm_state = kv_lm_step(self.weights, self._input, self._lm_state)
        K6.lm_coder(pdfs[None], self._syms, self._coder, self._bits, decode=False)
        self._input = self._syms[0].long() + 1
        n_bits, data, overflow = self._fetch()
        if overflow:
            raise ValueError(f'a code outside 0..{self.card - 1}')
        whole = n_bits // 8
        # rebase: the partial byte moves to the front, the cursor with it
        self._bits.zero_()
        if n_bits % 8:
            self._bits[:1].fill_(data[whole])
        self._coder.narrow(0, K6.BIT_POS, 1).fill_(n_bits % 8)
        return data[:whole]

    def flush(self) -> bytes:
        """The coder's last bits, zero-padded to a byte. It ends the stream:
        the bits are not taken from the coder's state, so a push or a flush
        after it would repeat them and the decoder would lose its place;
        both raise."""
        if self._finished:
            raise RuntimeError('flush() called twice: the stream is ended')
        self._finished = True
        none = torch.empty(0, self.K, self.card, device=self.device)
        K6.lm_coder(none, self._syms[:0], self._coder, self._bits, decode=False, finish=True)
        n_bits, data, _ = self._fetch()
        return data[:K6.stream_bytes(n_bits)]


class StreamingLmDecoder(_StreamCoder):
    """Feed the stream's bytes as they arrive, and pull frames as they can
    be decoded: :meth:`pull_frame` returns None while bytes are missing.

    The received bytes live in a buffer on the device, which starts at the
    most one frame can take; a push that would overflow it first drops the
    bytes the decoder has read (and grows it if that is not room enough),
    rebasing the coder's bit cursor."""

    def __init__(self, lm: LMModel, K: int):
        super().__init__(lm, K)
        self._bits = torch.zeros(K6.stream_bytes(bits_capacity(K)), dtype=torch.uint8,
                                 device=self.device)
        self._filled = 0        # bytes in the buffer
        self._read = 0          # bits read, as of the last frame pulled

    def push_bytes(self, data: bytes) -> None:
        n = len(data)
        if not n:
            return
        if self._filled + n > self._bits.numel():
            drop = self._read // 8
            keep = self._filled - drop
            bits = torch.zeros(max(self._bits.numel(), 2 * (keep + n)), dtype=torch.uint8,
                               device=self.device)
            bits[:keep].copy_(self._bits[drop:self._filled])
            self._bits, self._filled, self._read = bits, keep, self._read - 8 * drop
            self._coder.narrow(0, K6.BIT_POS, 1).fill_(self._read)
        _upload(self._bits[self._filled:self._filled + n],
                torch.frombuffer(bytearray(data), dtype=torch.uint8))
        self._filled += n

    def pull_frame(self) -> tp.Optional[np.ndarray]:
        """The next frame's codes ``[K]`` int64, or None when its bits have not
        all arrived (the decoder is then as it was; the ring slot the step
        wrote is written again, with the same values, by the retry)."""
        pdfs, state = kv_lm_step(self.weights, self._input, self._lm_state)
        K6.lm_coder(pdfs[None], self._syms, self._coder, self._bits, decode=True,
                    n_bits_in=8 * self._filled, stall=True)
        host = torch.cat([self._coder, self._syms[0].long()]).cpu().numpy()
        if host[K6.STALLED]:
            return None
        self._lm_state = state
        self._input = self._syms[0].long() + 1
        self._read = int(host[K6.BIT_POS])
        return host[K6.STATE_SIZE:].copy()
