"""Objective audio quality metrics: STOI, SI-SNR, multi-scale mel distance,
and PESQ and ViSQOL where their packages are installed.

Port of ``encodec_pytorch_tpu/metrics.py``. STOI (Taal et al. 2010, with
pystoi's conventions: frame enumeration, eps guards, the extended form's
row/column normalization) and SI-SNR are numpy; the mel distance is the
``l_f`` loss's log-mel L1 term through the port's ``ops/stft.audio_to_mel``,
on the card unless ``device='cpu'``. ``pesq_score`` and ``visqol_score``
return None when their package is absent.
"""

from typing import Optional

import numpy as np
import torch

from .data.audio_io import resample


def si_snr(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Scale-invariant SNR in dB."""
    x = np.asarray(reference, np.float64).reshape(-1)
    y = np.asarray(estimate, np.float64).reshape(-1)
    n = min(len(x), len(y))
    x, y = x[:n] - x[:n].mean(), y[:n] - y[:n].mean()
    s = (np.dot(y, x) / (np.dot(x, x) + 1e-12)) * x
    e = y - s
    return float(10 * np.log10((np.dot(s, s) + 1e-12) / (np.dot(e, e) + 1e-12)))


def mel_distance(reference: np.ndarray, estimate: np.ndarray, sample_rate: int,
                 device: str = 'cuda') -> float:
    """Mean over 7 scales (n_fft 32..2048, hop n_fft / 4, 64 mels) of the mean
    |log-mel difference|, in float32 on ``device``."""
    from .ops.stft import audio_to_mel
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device; pass device="cpu" to score on the CPU')
    x = torch.as_tensor(np.asarray(reference, np.float32).reshape(1, -1), device=device)
    y = torch.as_tensor(np.asarray(estimate, np.float32).reshape(1, -1), device=device)
    n = min(x.shape[-1], y.shape[-1])
    x, y = x[:, :n], y[:, :n]
    total = 0.0
    for i in range(5, 12):
        kwargs = dict(n_fft=2 ** i, win_length=2 ** i, hop_length=(2 ** i) // 4,
                      sampling_rate=sample_rate, n_mel_channels=64)
        total += float(torch.mean(torch.abs(audio_to_mel(x, **kwargs)
                                            - audio_to_mel(y, **kwargs))))
    return total / 7


_STOI_FS = 10000
_FRAME = 256
_HOP = 128
_NFFT = 512
_NBANDS = 15
_MINFREQ = 150
_SEG = 30          # 384 ms analysis segments
_BETA = -15.0      # lower SDR clip bound
_DYN_RANGE = 40.0  # silent-frame removal threshold


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    """One-third octave band matrix and centre frequencies."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = np.power(2.0, k / 3.0) * min_freq
    freq_low = min_freq * np.power(2.0, (2 * k - 1) / 6.0)
    freq_high = min_freq * np.power(2.0, (2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = np.argmin(np.square(f - freq_low[i]))
        hi = np.argmin(np.square(f - freq_high[i]))
        obm[i, lo:hi] = 1
    return obm, cf


def _frames(x: np.ndarray, frame_len: int, hop: int) -> np.ndarray:
    """Frames starting at ``range(0, len(x) - frame_len, hop)``: pystoi's
    enumeration, which drops the last frame when ``(len - frame_len) % hop``
    is 0."""
    n = max(0, -(-(len(x) - frame_len) // hop))
    idx = np.arange(n)[:, None] * hop + np.arange(frame_len)[None, :]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range, frame_len, hop):
    w = np.hanning(frame_len + 2)[1:-1]
    xf = _frames(x, frame_len, hop) * w
    yf = _frames(y, frame_len, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + np.finfo(np.float64).eps)
    mask = energies > (energies.max() - dyn_range)
    xf, yf = xf[mask], yf[mask]
    n_out = (len(xf) - 1) * hop + frame_len if len(xf) else 0
    x_out = np.zeros(n_out)
    y_out = np.zeros(n_out)
    for i in range(len(xf)):
        x_out[i * hop:i * hop + frame_len] += xf[i]
        y_out[i * hop:i * hop + frame_len] += yf[i]
    return x_out, y_out


def _row_col_normalize(seg: np.ndarray, eps: float) -> np.ndarray:
    """Extended STOI's normalization: each band row over time, then each
    time column over bands, to zero mean and unit norm (no tie-breaking
    noise)."""
    s = seg - seg.mean(axis=1, keepdims=True)
    s = s / (np.linalg.norm(s, axis=1, keepdims=True) + eps)
    s = s - s.mean(axis=0, keepdims=True)
    s = s / (np.linalg.norm(s, axis=0, keepdims=True) + eps)
    return s


def stoi(reference: np.ndarray, estimate: np.ndarray, sample_rate: int,
         extended: bool = False) -> float:
    """Short-Time Objective Intelligibility, about [0, 1]; ``extended`` gives
    extended STOI (Jensen & Taal 2016). Raises ValueError when the signal,
    less its silent frames, is shorter than one 384 ms segment."""
    eps = np.finfo(np.float64).eps
    x = np.asarray(reference, np.float64).reshape(-1)
    y = np.asarray(estimate, np.float64).reshape(-1)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    if sample_rate != _STOI_FS:
        x = resample(x, sample_rate, _STOI_FS).astype(np.float64)
        y = resample(y, sample_rate, _STOI_FS).astype(np.float64)

    x, y = _remove_silent_frames(x, y, _DYN_RANGE, _FRAME, _HOP)
    if len(x) < _FRAME:
        raise ValueError('signal too short (or fully silent) for STOI')

    w = np.hanning(_FRAME + 2)[1:-1]
    xf = np.fft.rfft(_frames(x, _FRAME, _HOP) * w, _NFFT, axis=1)
    yf = np.fft.rfft(_frames(y, _FRAME, _HOP) * w, _NFFT, axis=1)

    obm, _ = _thirdoct(_STOI_FS, _NFFT, _NBANDS, _MINFREQ)
    X = np.sqrt(obm @ (np.abs(xf) ** 2).T)   # [bands, frames]
    Y = np.sqrt(obm @ (np.abs(yf) ** 2).T)
    if X.shape[1] < _SEG:
        raise ValueError('signal too short for STOI (needs >= 384 ms of speech)')

    if extended:
        d_sum = 0.0
        segs = 0
        for m in range(_SEG, X.shape[1] + 1):
            Xn = _row_col_normalize(X[:, m - _SEG:m], eps)
            Yn = _row_col_normalize(Y[:, m - _SEG:m], eps)
            d_sum += np.sum(Xn * Yn) / _SEG
            segs += 1
        return float(d_sum / segs)

    d_sum = 0.0
    count = 0
    c = 10 ** (-_BETA / 20)
    for m in range(_SEG, X.shape[1] + 1):
        Xs = X[:, m - _SEG:m]
        Ys = Y[:, m - _SEG:m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / \
            (np.linalg.norm(Ys, axis=1, keepdims=True) + eps)
        Ys_c = np.minimum(Ys * alpha, Xs * (1 + c))
        Xm = Xs - Xs.mean(axis=1, keepdims=True)
        Ym = Ys_c - Ys_c.mean(axis=1, keepdims=True)
        num = np.sum(Xm * Ym, axis=1)
        den = np.linalg.norm(Xm, axis=1) * np.linalg.norm(Ym, axis=1) + eps
        d_sum += np.sum(num / den)
        count += _NBANDS
    return float(d_sum / count)


_PESQ_RATE = 16000
_PESQ_MODES = ('wb', 'nb')


def pesq_score(reference: np.ndarray, estimate: np.ndarray, sample_rate: int,
               mode: str = 'wb') -> Optional[float]:
    """ITU-T PESQ through the ``pesq`` package, both signals resampled to
    16 kHz; None when the package is absent. The library's own errors (e.g.
    on silence) propagate."""
    if mode not in _PESQ_MODES:
        raise ValueError(f'mode must be one of {_PESQ_MODES}, got {mode!r}')
    try:
        from pesq import pesq
    except ImportError:
        return None
    x = resample(np.asarray(reference).reshape(-1), sample_rate, _PESQ_RATE)
    y = resample(np.asarray(estimate).reshape(-1), sample_rate, _PESQ_RATE)
    n = min(len(x), len(y))
    return float(pesq(_PESQ_RATE, x[:n], y[:n], mode))


def visqol_score(reference: np.ndarray, estimate: np.ndarray, sample_rate: int,
                 mode: str = 'audio') -> Optional[float]:
    """ViSQOL MOS-LQO through google/visqol's Python bindings (``audio``: 48
    kHz; otherwise the 16 kHz speech model); None when they are absent."""
    try:
        from visqol import visqol_lib_py
        from visqol.pb2 import visqol_config_pb2
    except ImportError:
        return None
    config = visqol_config_pb2.VisqolConfig()
    if mode == 'audio':
        target_sr = 48000
        config.options.use_speech_scoring = False
        svr = 'libsvm_nu_svr_model.txt'
    else:
        target_sr = 16000
        config.options.use_speech_scoring = True
        svr = 'lattice_tcditugenmeetpackhref_ls2_nl60_lr12_bs2048_learn.005_ep2400_train1_7_raw.tflite'
    config.audio.sample_rate = target_sr
    config.options.svr_model_path = visqol_lib_py.FilePath(svr).Path()
    api = visqol_lib_py.VisqolApi()
    api.Create(config)
    x = resample(np.asarray(reference, np.float64).reshape(-1), sample_rate, target_sr)
    y = resample(np.asarray(estimate, np.float64).reshape(-1), sample_rate, target_sr)
    return float(api.Measure(x.astype(np.float64), y.astype(np.float64)).moslqo)
