"""Batch-assembly kernel: corpus + background noise -> one augmented training batch.

Hopper counterpart of ``honk_tpu/ops/assemble_kernel.py`` (Pallas
``_assemble_call`` / ``_make_kernel``, packers ``pack_pool_subrows`` and
``pack_noise_subrows``). The CUDA source is ``csrc/assemble.cu``; its header
says what bounds it on the card (bytes: 10 per output sample) and how the
design meets that. Per sample ``b`` and output position ``t < n_samples``:

    out[b, t] = clamp(float(pool[clip_start[b] + t]) * gain[b]
                      + noise[noise_start[b] + t] * nscale[b], -1, 1)

with ``pool`` the flat int16 corpus, ``noise`` the flat f32 noise, int64
start offsets in samples and f32 ``gain`` (1/32768, or 0 for a silence
slot) and ``nscale``. The TPU kernel's five scalars are a case of this:
``clip_start = (base8 * 8 + fine) * 128`` into the sub-row pool and
``noise_start = nsub8 * 8 * 128`` into the sub-row noise.

``assemble`` is the wrapper: on CUDA tensors it launches the kernel (or
raises), on CPU tensors it runs ``assemble_plain``, the same formula as
plain indexing, a multiply, a multiply, an add and a clamp. ``launches``
counts kernel launches. Offsets are in range by construction (the
samplers in ``data/augment.py`` make them so, as ``dynamic_slice`` keeps
them in JAX); ``assemble_plain`` checks them, the kernel does not (that
would cost a device-to-host copy per step).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

launches = 0
LANES = 128
N_SAMPLES = 16000
CP = 136  # sub-rows the TPU kernel copies per sample: 125 of audio + 8 residual, 8-aligned
MAX_BATCH = 65535  # the kernel's grid puts the batch on gridDim.y


def _geometry(timeshift_samples: int) -> tuple[int, int, int]:
    """(pad_sub, row_subs, q_max) of the sub-row layout for a max shift in samples."""
    pad_sub = max(1, -(-timeshift_samples // LANES))  # ceil
    s_max = 2 * pad_sub  # start sub-row range is [0, 2*pad_sub]
    row_subs = -(-((s_max // 8) * 8 + CP) // 8) * 8
    return pad_sub, row_subs, min(pad_sub, timeshift_samples // LANES)


def pack_pool_subrows(audio_i16, timeshift_samples: int = 1600) -> torch.Tensor:
    """(N, 16000) int16 -> (N * ROW_SUBS, 128) int16 CPU tensor, the TPU kernel's layout.

    Each clip takes ``row_subs`` sub-rows of 128 samples: ``pad_sub`` zero
    sub-rows, 125 sub-rows of audio, zeros to the end of the row.
    """
    audio_i16 = np.asarray(audio_i16, np.int16)
    n, s = audio_i16.shape
    if s != N_SAMPLES:
        raise ValueError(f"the sub-row layout takes 1 s clips ({N_SAMPLES} samples); got {s}")
    pad_sub, row_subs, _ = _geometry(timeshift_samples)
    packed = np.zeros((n, row_subs * LANES), np.int16)
    packed[:, pad_sub * LANES : pad_sub * LANES + s] = audio_i16
    return torch.from_numpy(packed.reshape(n * row_subs, LANES))


def pack_noise_subrows(noise, min_subrows: int = 2 * CP) -> torch.Tensor:
    """1-D float noise -> (M, 128) float32 CPU tensor, tiled to at least ``min_subrows`` sub-rows."""
    noise = np.asarray(noise, np.float32).reshape(-1)
    if noise.shape[0] < min_subrows * LANES:
        reps = -(-min_subrows * LANES // max(1, noise.shape[0]))
        noise = np.tile(noise, reps)
    m = noise.shape[0] // LANES
    return torch.from_numpy(np.ascontiguousarray(noise[: m * LANES].reshape(m, LANES)))


def _check(pool, noise, clip_start, noise_start, gain, nscale, n_samples) -> None:
    B = clip_start.shape[0] if clip_start.ndim == 1 else -1
    ok = (
        pool.ndim == 1 and noise.ndim == 1 and 1 <= B <= MAX_BATCH and n_samples >= 1
        and all(a.shape == (B,) for a in (noise_start, gain, nscale))
        and pool.dtype == torch.int16 and noise.dtype == torch.float32
        and clip_start.dtype == noise_start.dtype == torch.int64
        and gain.dtype == nscale.dtype == torch.float32
    )
    if not ok:
        raise ValueError(
            "assemble takes flat int16 pool, flat float32 noise, int64 clip_start / "
            f"noise_start (B,), float32 gain / nscale (B,), 1 <= B <= {MAX_BATCH}; got "
            + ", ".join(f"{tuple(a.shape)} {a.dtype}" for a in (pool, noise, clip_start, noise_start, gain, nscale))
        )
    args = (pool, noise, clip_start, noise_start, gain, nscale)
    if any(a.device != pool.device or not a.is_contiguous() for a in args):
        raise ValueError("assemble takes contiguous tensors on one device")


def assemble_plain(pool, noise, clip_start, noise_start, gain, nscale, n_samples: int = N_SAMPLES) -> torch.Tensor:
    """The kernel's formula as plain PyTorch ops: (B, n_samples) float32."""
    for name, start, src in (("clip_start", clip_start, pool), ("noise_start", noise_start, noise)):
        if bool((start < 0).any()) or bool((start + n_samples > src.shape[0]).any()):
            raise ValueError(f"{name} out of range: a window of {n_samples} must lie in {src.shape[0]} samples")
    t = torch.arange(n_samples, device=pool.device)
    audio = pool[clip_start[:, None] + t].float() * gain[:, None]
    mix = noise[noise_start[:, None] + t] * nscale[:, None]
    return (audio + mix).clamp(-1.0, 1.0)


def assemble(pool, noise, clip_start, noise_start, gain, nscale, n_samples: int = N_SAMPLES) -> torch.Tensor:
    """(B, n_samples) float32 batch: the kernel on CUDA, plain on CPU."""
    _check(pool, noise, clip_start, noise_start, gain, nscale, n_samples)
    args = (pool, noise, clip_start, noise_start, gain, nscale)
    if pool.device.type == "cpu":
        return assemble_plain(*args, n_samples=n_samples)
    if pool.device.type != "cuda":
        raise ValueError(f"assemble runs on cuda or cpu tensors, not {pool.device}")
    return _launch(*args, n_samples)


def _launch(pool, noise, clip_start, noise_start, gain, nscale, n_samples) -> torch.Tensor:
    global launches
    lib = _build.load("assemble")
    fn = lib.assemble_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B = clip_start.shape[0]
    out = torch.empty((B, n_samples), dtype=torch.float32, device=pool.device)
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = fn(
            pool.data_ptr(), noise.data_ptr(), clip_start.data_ptr(), noise_start.data_ptr(),
            gain.data_ptr(), nscale.data_ptr(), out.data_ptr(), B, n_samples, stream,
        )
    _build.check(err, "assemble")
    launches += 1
    return out
