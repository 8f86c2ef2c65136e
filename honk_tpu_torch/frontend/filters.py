"""Precomputed constant matrices for the MFCC frontend.

Reproduces, in pure numpy (float64), the exact filter constructions the
reference pipeline obtains from librosa (reference:
``utils/manage_audio.py::AudioPreprocessor`` — mel spectrogram with
``n_fft=480, hop=160, n_mels=40, fmin=20, fmax=4000`` at 16 kHz, log of
positive energies, then ``librosa.filters.dct(40, 40)``):

- periodic Hann window (scipy ``get_window('hann', n, fftbins=True)``)
- real-DFT basis matrices (cos / -sin), so the STFT runs as two matrix
  products instead of an FFT butterfly (GEMM-native NDFT frontend pattern)
- Slaney-scale mel filterbank with 'slaney' area normalization
  (librosa.filters.mel defaults, htk=False)
- orthonormal DCT-II basis (old librosa.filters.dct)

A copy of ``honk_tpu.frontend.filters`` (the port imports nothing of the
JAX package); tests hold the two exactly equal. Everything here is
host-side setup code executed once; ``honk_tpu_torch.frontend.mfcc``
turns the float32 matrices into device tensors.
"""

from __future__ import annotations

import functools

import numpy as np

# Reference frontend hyperparameters (utils/manage_audio.py defaults).
SAMPLE_RATE = 16000
N_FFT = 480  # 30 ms window
HOP_LENGTH = 160  # 10 ms hop
N_MELS = 40
N_DCT = 40
F_MIN = 20.0
F_MAX = 4000.0
N_RFFT = N_FFT // 2 + 1  # 241
AUDIO_SAMPLES = SAMPLE_RATE  # 1 s utterances
# center=True framing: reflect-pad n_fft//2 on both sides.
N_FRAMES = 1 + AUDIO_SAMPLES // HOP_LENGTH  # 101


def hann_window(n_fft: int = N_FFT) -> np.ndarray:
    """Periodic Hann window, matching scipy.signal.get_window('hann', n, fftbins=True)."""
    k = np.arange(n_fft, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft)


def rdft_matrices(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis: returns (cos_mat, sin_mat), each (n_fft, n_rfft).

    ``frames @ cos_mat`` = Re(rfft(frames)); ``frames @ sin_mat`` = Im(rfft(frames)).
    """
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang), -np.sin(ang)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = f_sp * m
    above = m >= min_log_mel
    f = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return f


def mel_filterbank(
    sr: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    n_mels: int = N_MELS,
    fmin: float = F_MIN,
    fmax: float = F_MAX,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_rfft).

    Matches librosa.filters.mel(sr, n_fft, n_mels=..., fmin=..., fmax=...,
    htk=False, norm='slaney').
    """
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_min = _hz_to_mel_slaney(np.array(fmin))
    mel_max = _hz_to_mel_slaney(np.array(fmax))
    mels = np.linspace(mel_min, mel_max, n_mels + 2)
    mel_f = _mel_to_hz_slaney(mels)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights


def dct_basis(n_filters: int = N_DCT, n_input: int = N_MELS) -> np.ndarray:
    """Orthonormal DCT-II basis, shape (n_filters, n_input).

    Matches the old librosa.filters.dct(n_filters, n_input) used by the
    reference AudioPreprocessor.
    """
    basis = np.empty((n_filters, n_input), dtype=np.float64)
    basis[0, :] = 1.0 / np.sqrt(n_input)
    samples = np.arange(1, 2 * n_input, 2, dtype=np.float64) * np.pi / (2.0 * n_input)
    for i in range(1, n_filters):
        basis[i, :] = np.cos(i * samples) * np.sqrt(2.0 / n_input)
    return basis


@functools.lru_cache(maxsize=None)
def frontend_constants(dtype=np.float32):
    """All frontend constant matrices, cast once to `dtype`.

    Returns dict with: window (n_fft,), dft_cos/dft_sin (n_fft, n_rfft),
    mel (n_rfft, n_mels)  [transposed for frames @ mel],
    dct (n_mels, n_dct)   [transposed for logmel @ dct].
    """
    window = hann_window()
    cos_m, sin_m = rdft_matrices()
    mel = mel_filterbank().T  # (241, 40)
    dct = dct_basis().T  # (40, 40)
    return {
        "window": window.astype(dtype),
        "dft_cos": cos_m.astype(dtype),
        "dft_sin": sin_m.astype(dtype),
        "mel": mel.astype(dtype),
        "dct": dct.astype(dtype),
    }
