"""The LM entropy coder's CDF quantization and range coder: the CUDA kernel K6
(``csrc/lm_coder.cu``) and its plain version.

Port of the coder inside the ``lax.scan`` of
``encodec_pytorch_tpu/bitstream/fused.py`` (``build_cdf_device``,
``ac_encode_symbol``, ``ac_encode_flush``, ``ac_decode_symbol``). For each
step's K pdfs ``[K, card]`` float32 it builds the quantized CDFs of
``bitstream/ac.py`` ``build_stable_quantized_cdf`` bit for bit and runs the
same range coder, so for the same pdfs the bytes are the host coder's.

:func:`lm_coder` codes ``steps`` steps against ``pdfs [steps, K, card]``:

- encode (``decode=False``) pushes the symbols ``syms [steps, K]`` int32 and,
  with ``finish``, flushes the rest of the range;
- decode writes the symbols it pulls into ``syms``;
- with ``stall`` (decode only: the kernel's STREAM mode, for a decoder fed
  bytes as they arrive) decode first checks, before each symbol, that the
  bits its renormalization reads have arrived (``bit_pos + need <=
  n_bits_in``, ``need`` known before any is read, as the JAX package's
  stream step checks, ``encodec_pytorch_tpu/bitstream/fused.py:656-661``);
  when they have not, the call stalls: it decodes nothing further and sets
  ``stalled``, leaving every other slot of the state as the call found it
  (the symbols before the stall are written to ``syms`` all the same), so
  the caller retries the same steps once more bytes have arrived; a call
  that does not stall stores its state with ``stalled`` 0. The stall check
  takes the place of the overrun check.

The coder's state is an int64 tensor of :data:`STATE_SIZE` slots (``low``,
``high``, ``current``, ``max_bit``, ``bit_pos``, ``overrun``, ``overflow``,
``stalled``) from :func:`init_state`, and the stream a zeroed uint8 buffer of
``ceil(cap_bits / 8)`` bytes, bits LSB-first (``np.packbits(...,
bitorder='little')``); both are updated in place and stay on the device
between calls. ``bit_pos`` is the bits written (after ``finish``, the
stream's length) or read; ``overrun`` is set when decode reads past
``n_bits_in`` (the host decoder's end of stream), ``overflow`` when encode
would write past ``cap_bits`` or meets a symbol outside the card (then
coded as 0): the symbols stay on the device, so they are checked there.

On a CUDA tensor :func:`lm_coder` launches K6 and raises on what the kernel
does not take: a decode is one launch (one CTA: warps that build the rows'
CDFs, a warp that codes each row once it is built); an encode of at most
:data:`ENCODE_FUSED_ROWS` symbols is one launch, a longer one two (the CDF
pairs ``(cdf[sym - 1], cdf[sym])`` of every symbol on many CTAs into a
scratch tensor, then one warp codes them), each wrapper call counted once in
``lm_coder.launches``. On a CPU tensor it runs the plain version, the CDF
build in torch float32 ops with an int64 ``cumsum`` (encode: only the pairs,
:func:`cdf_pairs_reference`) and the coder's transitions in Python integers,
step by step.
The decoder's symbol is ``#(current >= low + eff_low[i]) - 1`` over the bins
(clamped at 0), which on a valid stream is the host decoder's binary-search
result. :func:`build_cdf` gives the CDFs alone, for checks against the host
build: on CUDA it is K6 in a mode that writes its CDFs out and codes nothing
(a launch counted in ``lm_coder.launches``); the codec never calls it.
"""

import functools
import math

import numpy as np
import torch

from . import _build

TOTAL_RANGE_BITS = 24
ROUNDOFF = 1e-8
MIN_RANGE = 2
MAX_CARD = 8192     # the bins of a row the kernel takes at most
ENCODE_FUSED_ROWS = 64      # an encode of more symbols takes two launches and a scratch tensor
LOW, HIGH, CURRENT, MAX_BIT, BIT_POS, OVERRUN, OVERFLOW, STALLED = range(8)
STATE_SIZE = 8
ENCODE, DECODE, CDF, STREAM = range(4)     # the kernel's modes


@functools.lru_cache(maxsize=None)
def cdf_scale(card: int) -> float:
    """``float32((1 - alpha) · 2^24)`` with ``alpha = 2 · card / 2^24``."""
    total = 2 ** TOTAL_RANGE_BITS
    return float(np.float32((1 - MIN_RANGE * card / total) * total))


def init_state(device=None) -> torch.Tensor:
    """A fresh coder state: ``low = high = current = 0``, ``max_bit = -1``."""
    state = torch.zeros(STATE_SIZE, dtype=torch.int64, device=device)
    state.narrow(0, MAX_BIT, 1).fill_(-1)     # a fill: no host-to-device copy
    return state


def build_cdf_reference(pdfs: torch.Tensor) -> torch.Tensor:
    """``[..., card]`` float32 pdfs → quantized CDFs as int64, in torch on the
    pdfs' device. The roundoff divides by a tensor: on CUDA a division by a
    scalar is done as a product with its reciprocal, which rounds otherwise.
    A range converts to int32 as the card (and XLA) convert, saturating, NaN
    to 0, and the sums wrap at 32 bits as K6's (and the JAX package's) int32
    scan does; the pdfs of a model (in [0, 1]) reach neither."""
    roundoff = torch.full_like(pdfs, ROUNDOFF)
    q = torch.floor(pdfs / roundoff) * roundoff
    scale = torch.full_like(pdfs, cdf_scale(pdfs.shape[-1]))
    ranges = torch.floor(scale * q).double().nan_to_num(0.0).clamp(-2 ** 31, 2 ** 31 - 1)
    cdf = torch.cumsum(ranges.to(torch.int64) + MIN_RANGE, dim=-1)
    return (cdf + 2 ** 31) % 2 ** 32 - 2 ** 31


def cdf_pairs_reference(pdfs: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """``[..., card]`` float32 pdfs and ``[...]`` symbols → ``[..., 2]`` int64:
    ``(cdf[sym - 1], cdf[sym])`` of each row's quantized CDF (``cdf[-1] = 0``),
    what K6's encode reads of a row; a symbol outside the card takes symbol
    0's pair (the coder codes it as 0 and flags it)."""
    cdf = build_cdf_reference(pdfs)
    s = syms.to(device=cdf.device, dtype=torch.int64)
    s = torch.where((s >= 0) & (s < pdfs.shape[-1]), s, 0)[..., None]
    high = cdf.gather(-1, s)
    low = torch.where(s > 0, cdf.gather(-1, (s - 1).clamp(min=0)), 0)
    return torch.cat([low, high], dim=-1)


M64 = (1 << 64) - 1
_ROUND_UP = (1 << TOTAL_RANGE_BITS) - 1


def _msb(x: int) -> int:
    return x.bit_length() - 1      # -1 for 0


def lm_coder_reference(pdfs: torch.Tensor, syms: torch.Tensor, state: torch.Tensor,
                       bits: torch.Tensor, decode: bool, n_bits_in: int = 0,
                       finish: bool = False, stall: bool = False) -> None:
    """The plain version of :func:`lm_coder` on tensors of any device: the
    CDFs in torch, then the transitions in Python integers, a step at a time;
    ``syms`` (decode), ``state`` and ``bits`` are updated in place. The
    integers wrap at 64 bits as the kernel's do, which only a corrupt stream
    reaches (a valid one stays below 2^62)."""
    if stall and not decode:
        raise ValueError('lm_coder: stall is a decode mode')
    steps, K, _ = pdfs.shape
    start = state.tolist()
    low, high, current, max_bit, bit_pos, overrun, overflow = start[:7]
    low, high, current = low & M64, high & M64, current & M64
    buf = bits.cpu().numpy()
    cap_bits = 8 * buf.size
    out = syms.cpu().numpy().copy()

    def emit(value: int, top: int, n: int):
        nonlocal bit_pos, overflow
        for j in range(n):
            pos = bit_pos + j
            if pos >= cap_bits:
                overflow = 1
                break
            if (value >> (top - j)) & 1:
                buf[pos >> 3] |= 1 << (pos & 7)
        bit_pos += n

    def read(n: int) -> int:
        v = 0
        for i in range(n):
            pos = bit_pos + i
            v = (v << 1) | ((int(buf[pos >> 3]) >> (pos & 7)) & 1 if pos < cap_bits else 0)
        return v

    pairs = None if decode else cdf_pairs_reference(pdfs, syms).cpu().numpy()
    stalled = False
    for s in range(steps):
        if stalled:
            break
        if decode:
            cdfs = build_cdf_reference(pdfs[s]).cpu().numpy()
            range_lows = np.concatenate([np.zeros((K, 1), np.int64), cdfs[:, :-1]],
                                        axis=1).astype(np.uint64)
        for k in range(K):
            n = max(0, TOTAL_RANGE_BITS - _msb((high - low + 1) & M64))
            if stall and bit_pos + n > n_bits_in:
                stalled = True
                break
            if decode:
                current = ((current << n) | read(n)) & M64
                overrun |= int(bit_pos + n > n_bits_in)
                bit_pos += n
            low = (low << n) & M64
            high = ((high << n) | ((1 << n) - 1)) & M64
            max_bit += n
            d = (high - low + 1) & M64
            if decode:
                # #(current >= low + eff_low[i]) - 1, in uint64 as the kernel wraps
                eff_lows = (range_lows[k] * np.uint64(d) + np.uint64(_ROUND_UP)) \
                    >> np.uint64(TOTAL_RANGE_BITS)
                count = int(np.count_nonzero(np.uint64(current) >= np.uint64(low) + eff_lows))
                sym = max(count - 1, 0)
                out[s, k] = sym
                range_low = int(cdfs[k, sym - 1]) if sym else 0
                range_high = int(cdfs[k, sym]) - 1
            else:
                if not 0 <= int(out[s, k]) < pdfs.shape[2]:
                    overflow = 1
                range_low, range_high = int(pairs[s, k, 0]), int(pairs[s, k, 1]) - 1
            eff_low = ((((range_low * d) & M64) + _ROUND_UP) & M64) >> TOTAL_RANGE_BITS
            eff_high = ((range_high * d) & M64) >> TOTAL_RANGE_BITS
            new_low, new_high = (low + eff_low) & M64, (low + eff_high) & M64
            m = _msb(new_low ^ new_high)
            keep = ((1 << (m + 1)) - 1) & M64
            if not decode:
                emit(new_low, max_bit, max_bit - m)
            low, high = new_low & keep, new_high & keep
            if decode:
                current &= keep
            max_bit = m
    if finish and not decode:
        emit(low, max_bit, max_bit + 1)
        max_bit = -1
    as_signed = [v - (1 << 64) if v >> 63 else v for v in (low, high, current)]
    new = start if stalled else as_signed + [max_bit, bit_pos, overrun, overflow, start[STALLED]]
    if stall:
        new[STALLED] = int(stalled)
    state.copy_(torch.tensor(new, dtype=torch.int64))
    bits.copy_(torch.from_numpy(buf))
    if decode:
        syms.copy_(torch.from_numpy(out))


_DTYPES = (torch.float32, torch.int32, torch.int64, torch.uint8)


def _refuse(pdfs, syms, state, bits) -> None:
    """Raise the reason a CUDA call of :func:`lm_coder` is refused."""
    device = pdfs.device
    if device.type != 'cuda':
        raise ValueError(f'lm_coder: tensors on {device}; CUDA or the CPU only')
    for name, t, dtype in zip(('pdfs', 'syms', 'state', 'bits'), (pdfs, syms, state, bits),
                              _DTYPES):
        if t.device != device:
            raise ValueError(f'lm_coder: {name} on {t.device}, pdfs on {device}')
        if t.dtype != dtype:
            raise TypeError(f'lm_coder: {name} must be {dtype}, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'lm_coder: {name} must be contiguous')
    if pdfs.dim() != 3 or syms.shape != pdfs.shape[:2]:
        raise ValueError(f'lm_coder: pdfs {tuple(pdfs.shape)} and syms {tuple(syms.shape)} '
                         'do not make [steps, K, card] and [steps, K]')
    if not 1 <= pdfs.shape[2] <= MAX_CARD:
        raise ValueError(f'lm_coder: card {pdfs.shape[2]} outside 1..{MAX_CARD}')
    raise ValueError(f'lm_coder: state {tuple(state.shape)} / bits {tuple(bits.shape)} '
                     f'are not [{STATE_SIZE}] / [n]')


def _accepts(pdfs, syms, state, bits) -> bool:
    """Whether K6 takes these tensors: one pass, no strings built."""
    shape = pdfs.shape
    index = pdfs.get_device()
    return (pdfs.is_cuda and pdfs.dtype is torch.float32 and syms.dtype is torch.int32
            and state.dtype is torch.int64 and bits.dtype is torch.uint8
            and syms.get_device() == index and state.get_device() == index
            and bits.get_device() == index
            and pdfs.is_contiguous() and syms.is_contiguous() and state.is_contiguous()
            and bits.is_contiguous() and len(shape) == 3 and syms.shape == shape[:2]
            and 1 <= shape[2] <= MAX_CARD and state.shape == _STATE_SHAPE and bits.dim() == 1)


_STATE_SHAPE = torch.Size([STATE_SIZE])


def _library():
    return _build._lib or _build.load()


def _stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as an address."""
    return torch._C._cuda_getCurrentRawStream(index)


def lm_coder(pdfs: torch.Tensor, syms: torch.Tensor, state: torch.Tensor,
             bits: torch.Tensor, decode: bool, n_bits_in: int = 0,
             finish: bool = False, stall: bool = False) -> None:
    """Encode or decode ``pdfs.shape[0]`` steps in place (``stall``: decode
    or stall); kernel K6 on CUDA."""
    if stall and not decode:
        raise ValueError('lm_coder: stall is a decode mode')
    if pdfs.is_cpu:
        lm_coder_reference(pdfs, syms, state, bits, decode, n_bits_in, finish, stall)
        return
    if not _accepts(pdfs, syms, state, bits):
        _refuse(pdfs, syms, state, bits)
    steps, K, card = pdfs.shape
    device = pdfs.get_device()
    scratch = None
    if not decode and steps * K > ENCODE_FUSED_ROWS:
        scratch = torch.empty(steps * K * 2, dtype=torch.int32, device=pdfs.device)
    mode = (STREAM if stall else DECODE) if decode else ENCODE
    rc = _library().encodec_lm_coder_f32(
        mode, pdfs.data_ptr(), steps, K, card, cdf_scale(card), syms.data_ptr(),
        state.data_ptr(), bits.data_ptr(), 8 * bits.numel(), n_bits_in, finish,
        None if scratch is None else scratch.data_ptr(), device, _stream(device))
    if rc:
        _build.check(rc, 'lm_coder kernel')
    lm_coder.launches += 1
    lm_coder.stall_launches += stall


lm_coder.launches = 0
lm_coder.stall_launches = 0     # the launches in the stall mode (also in ``launches``)


def lm_coder_floor(steps: int, K: int, card: int, device=None) -> None:
    """An empty launch with the block and shared memory of K6's decode of
    ``steps`` x ``K`` symbols of ``card`` bins, on the current stream: its
    device time is the floor a decode launch of that shape can reach. Not
    counted in ``lm_coder.launches``."""
    index = torch.device('cuda' if device is None else device).index
    index = torch.cuda.current_device() if index is None else index
    _build.check(_library().encodec_lm_coder_floor(steps, K, card, index, _stream(index)),
                 'lm_coder floor launch')


def build_cdf(pdfs: torch.Tensor) -> torch.Tensor:
    """``[..., card]`` float32 pdfs → quantized CDFs: int32 by K6's CDF mode
    on CUDA, int64 by :func:`build_cdf_reference` on the CPU."""
    if pdfs.is_cpu:
        return build_cdf_reference(pdfs)
    if pdfs.dtype != torch.float32 or pdfs.device.type != 'cuda':
        raise TypeError(f'build_cdf: float32 CUDA pdfs only, got {pdfs.dtype} on {pdfs.device}')
    card = pdfs.shape[-1]
    if not 1 <= card <= MAX_CARD:
        raise ValueError(f'build_cdf: card {card} outside 1..{MAX_CARD}')
    flat = pdfs.reshape(-1, card).contiguous()
    out = torch.empty(flat.shape, dtype=torch.int32, device=pdfs.device)
    device = pdfs.get_device()
    rc = _library().encodec_lm_coder_f32(
        CDF, flat.data_ptr(), 1, flat.shape[0], card, cdf_scale(card), out.data_ptr(), None,
        None, 0, 0, 0, None, device, _stream(device))
    _build.check(rc, 'lm_coder kernel (CDF mode)')
    lm_coder.launches += 1
    return out.reshape(pdfs.shape)


def bits_capacity(n_symbols: int) -> int:
    """Bits a stream of ``n_symbols`` can need: at most 24 renormalizations
    a symbol, each one emitted (encode) or read (decode) bit, plus slack for
    the final flush (at most 62 bits)."""
    return TOTAL_RANGE_BITS * (n_symbols + 2) + 128


def stream_bytes(n_bits: int) -> int:
    return math.ceil(n_bits / 8)
