"""Batched MFCC frontend on tensors (counterpart of ``honk_tpu.frontend.mfcc``).

Pipeline (reference ``utils/manage_audio.py::AudioPreprocessor`` numerics,
golden-tested against ``honk_tpu_torch.frontend.reference``):

    audio (B, 16000) f32
      -> reflect pad 240 both sides
      -> frames (B, 101, 480)
      -> * hann -> @ dft_cos, @ dft_sin -> power (B, 101, 241)
      -> @ mel.T -> (B, 101, 40)
      -> log where > 0 (zeros stay exactly 0)
      -> @ dct.T -> (B, 101, 40) MFCC

``frame_audio``, ``power_spectrum`` and ``mel_log`` are the plain steps;
``compute_mfccs`` goes through the fused MFCC kernel's wrapper
(``honk_tpu_torch.ops.mfcc_kernel.mfcc``), which runs the CUDA kernel on a
CUDA tensor and these plain steps on a CPU tensor. Everything is float32;
TF32 stays off (``honk_tpu_torch.use_full_f32``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics.profiling import annotate
from . import filters as C


@functools.lru_cache(maxsize=None)
def constants(device: torch.device) -> dict[str, torch.Tensor]:
    """The float32 frontend constants as row-major tensors on `device`, built once per device."""
    return {
        k: torch.from_numpy(v).to(device).contiguous()  # mel and dct are transposed views
        for k, v in C.frontend_constants(np.float32).items()
    }


def frame_audio(audio: torch.Tensor, n_fft: int = C.N_FFT, hop: int = C.HOP_LENGTH) -> torch.Tensor:
    """(B, n_samples) -> (B, n_frames, n_fft) with center=True reflect padding."""
    pad = n_fft // 2
    padded = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    return padded.unfold(-1, n_fft, hop)


def power_spectrum(frames: torch.Tensor) -> torch.Tensor:
    """Windowed GEMM-DFT power spectrum. (B, T, n_fft) -> (B, T, n_rfft)."""
    c = constants(frames.device)
    w = frames * c["window"]
    re = w @ c["dft_cos"]
    im = w @ c["dft_sin"]
    return re * re + im * im


def mel_log(power: torch.Tensor) -> torch.Tensor:
    """Mel projection + honk's positive-masked log. (B, T, n_rfft) -> (B, T, n_mels)."""
    mel = power @ constants(power.device)["mel"]
    return torch.where(mel > 0, torch.log(torch.where(mel > 0, mel, 1.0)), mel)


def compute_mfccs(audio: torch.Tensor) -> torch.Tensor:
    """Batched MFCC: (B, n_samples) float32 -> (B, n_frames, n_dct) float32.

    The JAX package's ``compute_mfccs`` also takes ``fast``, its
    training-grade tier (``honk_tpu/frontend/mfcc.py``: its DFT, mel and DCT
    matmuls in one bf16 pass on the TPU, 2.7e-2 from the float64 golden),
    which its bf16 train steps and bf16 ``make_forward`` take. That tier is
    an XLA precision setting, not a Pallas kernel, and the port has no
    cheaper tier to map it to: every caller runs this float32 MFCC kernel,
    which is more exact than the fast tier (within 5e-3 of the golden) and a
    small share of a step's device time (PERF.md §6), so a bf16 pass would
    have little to save.
    """
    if audio.ndim != 2:
        raise ValueError(
            f"compute_mfccs expects batched audio of shape (B, n_samples); got {tuple(audio.shape)}. "
            "For a single utterance, pass audio[None, :]."
        )
    if not audio.is_floating_point():
        raise ValueError(
            f"compute_mfccs expects float audio in [-1, 1]; got dtype {audio.dtype}. "
            "Convert int16 PCM first (x / 32768)."
        )
    from ..ops import mfcc_kernel  # the kernel module builds on the plain steps above

    with annotate("mfcc"):
        return mfcc_kernel.mfcc(audio.to(torch.float32).contiguous())
