"""Plain MFCC: a frozen copy of the port's frontend constants and plain steps.

librosa's pipeline as the Honk recipe runs it (``n_fft`` 480, hop 160, 40
Slaney mel filters over 20-4000 Hz at 16 kHz, the log of positive energies
only, an orthonormal DCT-II of 40): reflect-padded centre frames, a periodic
Hann window, the real DFT as two products against cos / sin bases, the
power, the mel projection, the masked log and the DCT. Float32 throughout;
the caller keeps TF32 off (``reference.no_tf32``). Constants are built in
float64 with numpy and rounded once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 480
HOP = 160
N_MELS = 40
N_DCT = 40
F_MIN = 20.0
F_MAX = 4000.0
WINDOW_FRAMES = 1 + SAMPLE_RATE // HOP  # 101 frames of a 1 s utterance


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank() -> np.ndarray:
    """(40, 241) Slaney-normalised triangular filters, as ``librosa.filters.mel(htk=False)``."""
    fftfreqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(np.array(F_MIN)), _hz_to_mel(np.array(F_MAX)), N_MELS + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return weights * (2.0 / (mel_f[2:N_MELS + 2] - mel_f[:N_MELS]))[:, None]


def dct_basis() -> np.ndarray:
    """(40, 40) orthonormal DCT-II basis."""
    basis = np.empty((N_DCT, N_MELS))
    basis[0] = 1.0 / np.sqrt(N_MELS)
    samples = np.arange(1, 2 * N_MELS, 2) * np.pi / (2.0 * N_MELS)
    for i in range(1, N_DCT):
        basis[i] = np.cos(i * samples) * np.sqrt(2.0 / N_MELS)
    return basis


@functools.lru_cache(maxsize=None)
def constants() -> dict[str, np.ndarray]:
    """window (480,), cos / sin (480, 241), mel (241, 40), dct (40, 40), all float32."""
    k = np.arange(N_FFT, dtype=np.float64)
    ang = 2.0 * np.pi * k[:, None] * np.arange(N_FFT // 2 + 1)[None, :] / N_FFT
    return {
        "window": (0.5 - 0.5 * np.cos(2.0 * np.pi * k / N_FFT)).astype(np.float32),
        "cos": np.cos(ang).astype(np.float32),
        "sin": (-np.sin(ang)).astype(np.float32),
        "mel": mel_filterbank().T.astype(np.float32),
        "dct": dct_basis().T.astype(np.float32),
    }


def mel_taps() -> int:
    """Nonzero taps of the float32 mel filters (the work counter's)."""
    return int(np.count_nonzero(constants()["mel"]))


def mfcc(audio: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) float32 in [-1, 1] -> (B, 1 + n_samples // 160, 40) float32, centre framing."""
    c = {k: torch.from_numpy(v).to(audio.device) for k, v in constants().items()}
    pad = N_FFT // 2
    frames = F.pad(audio.float()[:, None, :], (pad, pad), mode="reflect")[:, 0].unfold(-1, N_FFT, HOP)
    w = frames * c["window"]
    re, im = w @ c["cos"], w @ c["sin"]
    mel = (re * re + im * im) @ c["mel"]
    logmel = torch.where(mel > 0, torch.log(torch.where(mel > 0, mel, 1.0)), mel)
    return logmel @ c["dct"]
