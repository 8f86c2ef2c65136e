"""Fused MFCC kernel: framing -> window -> real FFT -> power -> mel -> log -> DCT.

Hopper counterpart of ``honk_tpu/ops/mfcc_kernel.py`` (Pallas
``_mfcc_rows`` / ``_mfcc_kernel``). The CUDA source is ``csrc/mfcc.cu``;
its header says what it computes per frame (a real FFT of 480 points as a
Stockham FFT of 240 complex points, radices ``FFT_RADICES``, then only the
``N_BINS`` bins the mel filters use, each filter a run of bins) and what
bounds it on the card. This module builds the kernel's tables on the host:
``fft_twiddles`` (float64, rounded to f32 for the card) and ``mel_runs``
(from the frontend's own mel matrix).

``mfcc`` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs ``mfcc_plain``, the same function as
plain PyTorch ops. Both take the framing: center (reflect padding, the
utterance frontend and offline streaming) or causal (no padding, the online
streaming step). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..frontend import filters as C
from ..frontend.mfcc import constants, frame_audio, mel_log, power_spectrum
from . import _build

launches = 0
N_CPLX = C.N_FFT // 2  # the 480 real samples packed as 240 complex ones
FFT_RADICES = (4, 4, 3, 5)  # one Stockham pass each: 4 * 4 * 3 * 5 = 240
N_BINS = 120  # the kernel computes bins 0..119 (csrc/mfcc.cu N_BINS)
FRAMES_PER_BLOCK = 4  # one warp per frame (csrc/mfcc.cu FRAMES)


def fft_twiddles(dtype=np.float64) -> np.ndarray:
    """The kernel's twiddle table, ``(428, 2)`` (real, imaginary), made in float64.

    For each pass of radix ``R`` after passes whose radices multiply to
    ``ns``, the ``ns * R`` factors ``exp(-2 pi i k r / (ns R))`` at
    ``k * R + r``; then ``exp(-2 pi i k / 480)`` for the split step's bins
    ``k = 0 .. N_BINS - 1``.
    """
    angles, ns = [], 1
    for r in FFT_RADICES:
        k, q = np.meshgrid(np.arange(ns), np.arange(r), indexing="ij")
        angles.append((-2.0 * np.pi * k * q / (ns * r)).ravel())
        ns *= r
    angles.append(-2.0 * np.pi * np.arange(N_BINS) / C.N_FFT)
    ang = np.concatenate(angles)
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(dtype)


def mel_runs(dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Each mel filter as a run of bins: ``(runs (40, 3) int32, taps)``.

    ``runs[m] = (start, length, offset)``: filter ``m``'s weights over bins
    ``start .. start + length - 1`` are ``taps[offset : offset + length]``,
    taken from the frontend's own mel matrix at ``dtype`` (zeros inside a
    run kept; none falls outside). Raises if a run reaches past the bins
    the kernel computes.
    """
    mel = C.frontend_constants(dtype)["mel"]  # (241, 40)
    runs, taps = [], []
    for m in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, m])
        start, stop = int(nz[0]), int(nz[-1]) + 1
        if stop > N_BINS:
            raise ValueError(f"mel filter {m} reaches bin {stop - 1}; the kernel computes bins < {N_BINS}")
        runs.append((start, stop - start, sum(len(t) for t in taps)))
        taps.append(mel[start:stop, m])
    return np.asarray(runs, np.int32), np.concatenate(taps).astype(dtype)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    runs, taps = mel_runs(np.float32)
    return {
        "twiddle": torch.from_numpy(fft_twiddles(np.float32)).to(device),
        "mel_runs": torch.from_numpy(runs).to(device),
        "mel_taps": torch.from_numpy(taps).to(device),
    }


def _check_framing(n_samples: int, center: bool, n_frames: int | None) -> int:
    """The frame count of ``n_samples`` in the given framing; raises if it does not fit."""
    if center:
        want = 1 + n_samples // C.HOP_LENGTH
        if n_frames not in (None, want):
            raise ValueError(f"center framing of {n_samples} samples has {want} frames, not {n_frames}")
        return want
    if n_frames is None or n_frames < 1 or (n_frames - 1) * C.HOP_LENGTH + C.N_FFT > n_samples:
        raise ValueError(
            f"causal framing needs 1 <= n_frames and (n_frames - 1) * {C.HOP_LENGTH} + {C.N_FFT} "
            f"<= n_samples; got n_frames {n_frames}, {n_samples} samples"
        )
    return n_frames


def frames_plain(audio: torch.Tensor, center: bool = True, n_frames: int | None = None) -> torch.Tensor:
    """(B, n_samples) -> (B, n_frames, 480): reflect-padded center frames, or
    causal frames at offsets 0, 160, ... with no pad (``n_frames`` of them)."""
    if center:
        return frame_audio(audio)
    return audio.unfold(-1, C.N_FFT, C.HOP_LENGTH)[:, :n_frames]


def mfcc_plain(audio: torch.Tensor, center: bool = True, n_frames: int | None = None) -> torch.Tensor:
    """(B, n_samples) f32 -> (B, n_frames, 40) f32 as plain PyTorch ops."""
    frames = frames_plain(audio, center, n_frames)
    return mel_log(power_spectrum(frames)) @ constants(audio.device)["dct"]


def mfcc(audio: torch.Tensor, center: bool = True, n_frames: int | None = None) -> torch.Tensor:
    """(B, n_samples) f32 -> (B, n_frames, 40) f32: the kernel on CUDA, plain on CPU.

    ``center=True`` frames with 240 samples of reflect padding on each side
    (``n_frames = 1 + n_samples // 160``). ``center=False`` is the online
    streaming step's causal framing: ``n_frames`` frames at offsets 0, 160,
    ... with no padding, as from a ``(N, 480 + chunk)`` buffer of the last
    480 samples and a chunk.
    """
    if audio.ndim != 2 or audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError(
            f"mfcc takes contiguous float32 audio (B, n_samples); got "
            f"{tuple(audio.shape)} {audio.dtype}"
        )
    if audio.shape[0] == 0 or audio.shape[1] <= C.N_FFT // 2:
        raise ValueError(f"mfcc needs B >= 1 and more than {C.N_FFT // 2} samples; got {tuple(audio.shape)}")
    n_frames = _check_framing(audio.shape[1], center, n_frames)
    if audio.device.type == "cpu":
        return mfcc_plain(audio, center, n_frames)
    if audio.device.type != "cuda":
        raise ValueError(f"mfcc runs on cuda or cpu tensors, not {audio.device}")
    return _launch(audio, center, n_frames)


def geometry(audio: torch.Tensor, center: bool = True, n_frames: int | None = None) -> dict:
    """The launch the kernel gets for ``audio`` (B, n_samples) in the given framing."""
    rows = audio.shape[0] * _check_framing(audio.shape[1], center, n_frames)
    return {"frames_per_block": FRAMES_PER_BLOCK, "threads": 32 * FRAMES_PER_BLOCK,
            "blocks": -(-rows // FRAMES_PER_BLOCK), "frames": rows}


def _launch(audio: torch.Tensor, center: bool, n_frames: int) -> torch.Tensor:
    global launches
    lib = _build.load("mfcc")
    fn = lib.mfcc_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, n_samples = audio.shape
    c, t = constants(audio.device), _tables(audio.device)
    out = torch.empty((B, n_frames, C.N_DCT), dtype=torch.float32, device=audio.device)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        err = fn(
            audio.data_ptr(), c["window"].data_ptr(), t["twiddle"].data_ptr(),
            t["mel_runs"].data_ptr(), t["mel_taps"].data_ptr(), c["dct"].data_ptr(),
            out.data_ptr(), B, n_samples, n_frames, C.N_FFT // 2 if center else 0, stream,
        )
    _build.check(err, "mfcc")
    launches += 1
    return out
