"""Fused MFCC kernel: reflect framing -> window -> DFT -> power -> mel -> log -> DCT.

Hopper counterpart of ``honk_tpu/ops/mfcc_kernel.py`` (Pallas
``_mfcc_rows`` / ``_mfcc_kernel``). The CUDA source is ``csrc/mfcc.cu``;
its header says what bounds it on the card (f32 FMAs, about 49.0 MFLOP
per utterance against about 80 KB of I/O) and how the design meets that.

``mfcc`` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs ``mfcc_plain``, the same function as
plain PyTorch ops. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..frontend import filters as C
from ..frontend.mfcc import constants, frame_audio, mel_log, power_spectrum
from . import _build

launches = 0


def mfcc_plain(audio: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) f32 -> (B, n_frames, 40) f32 as plain PyTorch ops."""
    return mel_log(power_spectrum(frame_audio(audio))) @ constants(audio.device)["dct"]


def mfcc(audio: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) f32 -> (B, n_frames, 40) f32: the kernel on CUDA, plain on CPU."""
    if audio.ndim != 2 or audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError(
            f"mfcc takes contiguous float32 audio (B, n_samples); got "
            f"{tuple(audio.shape)} {audio.dtype}"
        )
    if audio.shape[0] == 0 or audio.shape[1] <= C.N_FFT // 2:
        raise ValueError(f"mfcc needs B >= 1 and more than {C.N_FFT // 2} samples; got {tuple(audio.shape)}")
    if audio.device.type == "cpu":
        return mfcc_plain(audio)
    if audio.device.type != "cuda":
        raise ValueError(f"mfcc runs on cuda or cpu tensors, not {audio.device}")
    return _launch(audio)


def _launch(audio: torch.Tensor) -> torch.Tensor:
    global launches
    lib = _build.load("mfcc")
    fn = lib.mfcc_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, n_samples = audio.shape
    n_frames = 1 + n_samples // C.HOP_LENGTH
    c = constants(audio.device)
    out = torch.empty((B, n_frames, C.N_DCT), dtype=torch.float32, device=audio.device)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        err = fn(
            audio.data_ptr(), c["window"].data_ptr(), c["dft_cos"].data_ptr(),
            c["dft_sin"].data_ptr(), c["mel"].data_ptr(), c["dct"].data_ptr(),
            out.data_ptr(), B, n_samples, n_frames, stream,
        )
    _build.check(err, "mfcc")
    launches += 1
    return out
