"""Float64 numpy golden-reference MFCC.

Implements, step by step and at float64 precision, the exact computation
the reference performs through librosa (reference:
``utils/manage_audio.py::AudioPreprocessor.compute_mfccs``):

    S = |stft(y, n_fft=480, hop=160, hann, center=True, reflect pad)|^2
    M = mel_slaney(40, fmin=20, fmax=4000) @ S
    M[M > 0] = log(M[M > 0])            # zeros stay zero — NOT log(eps)
    out[t] = dct_ortho(40, 40) @ M[:, t]  -> (n_frames, 40) float32

This module is the oracle for the golden-value tests; it is NOT on any hot
path. The port's ``honk_tpu_torch.frontend.mfcc`` (and the fused CUDA
kernel behind it) is validated against it. A copy of
``honk_tpu.frontend.reference``.
"""

from __future__ import annotations

import numpy as np

from . import filters as F


def _frame_centered(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Reflect-pad by n_fft//2 on both ends and slice overlapping frames.

    audio: (n_samples,) -> (n_frames, n_fft)
    """
    pad = n_fft // 2
    padded = np.pad(audio, pad, mode="reflect")
    n_frames = 1 + len(audio) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return padded[idx]


def compute_mfccs_reference(
    audio: np.ndarray,
    sr: int = F.SAMPLE_RATE,
    n_fft: int = F.N_FFT,
    hop: int = F.HOP_LENGTH,
    n_mels: int = F.N_MELS,
    n_dct: int = F.N_DCT,
    fmin: float = F.F_MIN,
    fmax: float = F.F_MAX,
) -> np.ndarray:
    """Golden MFCC for one utterance. audio: (n_samples,) float -> (n_frames, n_dct) float32."""
    audio = np.asarray(audio, dtype=np.float64)
    frames = _frame_centered(audio, n_fft, hop)
    window = F.hann_window(n_fft)
    spec = np.fft.rfft(frames * window[None, :], n=n_fft, axis=-1)
    power = np.abs(spec) ** 2  # (n_frames, n_rfft)

    mel_fb = F.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)  # (n_mels, n_rfft)
    melspec = power @ mel_fb.T  # (n_frames, n_mels)

    logmel = np.where(melspec > 0, np.log(np.where(melspec > 0, melspec, 1.0)), melspec)

    dct = F.dct_basis(n_dct, n_mels)  # (n_dct, n_mels)
    mfcc = logmel @ dct.T  # (n_frames, n_dct)
    return mfcc.astype(np.float32)
