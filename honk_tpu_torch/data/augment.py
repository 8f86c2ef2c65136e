"""On-device batch assembly and augmentation (counterpart of ``honk_tpu.data.augment``).

Equivalent of the per-item augmentation in reference
``utils/train.py::SpeechDataset.__getitem__ / _timeshift_audio``: random
time-shift of +-100 ms with zero fill, background noise mixed in at
``a = rand() * 0.1`` with probability ``noise_prob``, silence = pure scaled
noise, clip to [-1, 1]. The packed corpus and the noise live on the device
for the whole run; a batch is drawn and assembled there.

Sampling is split in two:

- ``draw_batch`` makes the per-sample random draws on the device from an
  explicit ``torch.Generator``: clip index with virtual silence slots
  (``idx >= n``), shift, noise offset, add-noise uniform, scale uniform.
- ``assemble_batch`` turns draws into a batch deterministically, through
  the assembly kernel's wrapper (``ops.assemble_kernel.assemble``) on every
  device. A test can feed it the JAX package's own draws.

Two layouts of the corpus (``prepare_train_arrays``), both a start offset
per sample into a flat pool and a flat noise buffer:

- ``exact`` (the default on every device): the padded pool of ``pad_pool``
  and per-sample shifts, as ``honk_tpu.data.augment.sample_train_batch``;
  the noise offset is ``clip(row * stride, 0, len - 16000)`` into the noise
  tiled as ``make_noise_windows`` tiles it, without building the windows.
- ``subrow``: the TPU kernel's layout (``pack_pool_subrows``,
  ``pack_noise_subrows``), shifts rounded to 128 samples and noise offsets
  to 1024, as ``honk_tpu.ops.assemble_kernel.sample_train_batch_pallas``.
  The rounding served only the TPU's DMA alignment; it stays for parity.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..metrics.profiling import annotate
from ..ops import assemble_kernel as K


class AugmentConfig(NamedTuple):
    noise_prob: float = 0.8
    timeshift_samples: int = 1600  # +-100 ms at 16 kHz
    noise_scale: float = 0.1
    n_silence: int = 0  # virtual silence slots in the train sampler


class TrainArrays(NamedTuple):
    """The device-resident corpus of one layout, and how offsets into it are formed.

    A clip ``i`` shifted by ``k`` units starts at ``i * row_len + pad - k * unit``
    in ``pool``; noise row ``r`` starts at ``clip(r * stride, 0, len(noise) - n_samples)``.
    """

    layout: str  # "exact" or "subrow"
    pool: torch.Tensor  # flat int16
    noise: torch.Tensor  # flat float32
    labels: torch.Tensor  # (n_clips,) int64
    n_clips: int
    row_len: int  # samples per clip row of the pool
    pad: int  # offset of an unshifted clip in its row
    unit: int  # samples per shift step (1 exact, 128 sub-row)
    max_shift: int  # shifts are drawn from [-max_shift, max_shift] units
    stride: int  # samples between noise offsets
    n_noise: int  # noise offsets are drawn from [0, n_noise)
    n_samples: int = K.N_SAMPLES


class Draws(NamedTuple):
    """Per-sample random draws of one batch, all (B,) on one device."""

    idx: torch.Tensor  # int64 in [0, n_clips + n_silence); >= n_clips is a silence slot
    shift: torch.Tensor  # int64 in [-max_shift, max_shift] units; > 0 delays the clip
    noise_row: torch.Tensor  # int64 in [0, n_noise)
    add_u: torch.Tensor  # float32 uniform; noise is mixed in where < noise_prob (always for silence)
    scale_u: torch.Tensor  # float32 uniform; the noise scale is scale_u * noise_scale


def timeshift(audio: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Batched shift with zero fill. shift > 0 delays (moves content right).

    audio: (B, N) float32; shift: (B,) integer in [-ts, ts].
    """
    n = audio.shape[1]
    src = torch.arange(n, device=audio.device)[None, :] - shift[:, None]
    valid = (src >= 0) & (src < n)
    gathered = torch.gather(audio, 1, src.clamp(0, n - 1))
    return torch.where(valid, gathered, 0.0)


def pad_pool(audio_i16, timeshift_samples: int = 1600) -> torch.Tensor:
    """Zero-pad the packed corpus once: (N, S) -> (N, S + 2*ts) int16 CPU tensor."""
    audio_i16 = np.asarray(audio_i16, np.int16)
    return torch.from_numpy(np.pad(audio_i16, ((0, 0), (timeshift_samples, timeshift_samples))))


def make_noise_windows(noise, n_samples: int = 16000, stride: int = 2000) -> tuple[torch.Tensor, torch.Tensor]:
    """(M,) noise -> (tiled noise (M',) float32, window starts (R,) int64), CPU tensors.

    Window ``r`` of ``honk_tpu.data.augment.make_noise_windows`` is
    ``tiled[starts[r] : starts[r] + n_samples]``; the overlapping windows
    themselves are never built.
    """
    noise = np.asarray(noise, np.float32).reshape(-1)
    if noise.shape[0] < n_samples:
        noise = np.tile(noise, -(-n_samples // noise.shape[0]))
    n_off = max(1, (noise.shape[0] - n_samples) // stride + 1)
    starts = np.clip(np.arange(n_off) * stride, 0, noise.shape[0] - n_samples)
    return torch.from_numpy(noise), torch.from_numpy(starts.astype(np.int64))


def prepare_train_arrays(
    audio_i16, labels, noise, cfg: AugmentConfig, noise_stride: int = 2000,
    layout: str = "auto", device: str | torch.device = "cpu",
) -> TrainArrays:
    """One-time load-side prep of the device-resident corpus arrays.

    ``layout="auto"`` is ``exact`` on every device (module docstring);
    ``subrow`` is the TPU kernel's layout and needs 1 s clips.
    """
    audio_i16 = np.asarray(audio_i16, np.int16)
    n, n_samples = audio_i16.shape
    ts = cfg.timeshift_samples
    labels_t = torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(device)
    if layout in ("auto", "exact"):
        tiled, starts = make_noise_windows(noise, n_samples, noise_stride)
        return TrainArrays(
            "exact", pad_pool(audio_i16, ts).reshape(-1).to(device), tiled.to(device), labels_t,
            n_clips=n, row_len=n_samples + 2 * ts, pad=ts, unit=1, max_shift=ts,
            stride=noise_stride, n_noise=starts.shape[0], n_samples=n_samples,
        )
    if layout == "subrow":
        pad_sub, row_subs, q_max = K._geometry(ts)
        noise_sub = K.pack_noise_subrows(noise)
        return TrainArrays(
            "subrow", K.pack_pool_subrows(audio_i16, ts).reshape(-1).to(device),
            noise_sub.reshape(-1).to(device), labels_t,
            n_clips=n, row_len=row_subs * K.LANES, pad=pad_sub * K.LANES, unit=K.LANES,
            max_shift=q_max, stride=8 * K.LANES, n_noise=(noise_sub.shape[0] - K.CP) // 8 + 1,
            n_samples=n_samples,
        )
    raise ValueError(f"layout must be 'auto', 'exact' or 'subrow', not {layout!r}")


def step_generator(key: int, step: int, device: str | torch.device) -> torch.Generator:
    """The generator of train step ``step`` under run key ``key`` (JAX: ``fold_in(key, step)``).

    Seeded from (key, step) alone, so a resumed run draws the batches an
    unbroken run draws.
    """
    g = torch.Generator(device=device)
    g.manual_seed(((key & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return g


def draw_batch(generator: torch.Generator, arrays: TrainArrays, batch_size: int, cfg: AugmentConfig) -> Draws:
    """The per-sample draws of one batch, made on the generator's device."""
    dev = arrays.pool.device
    kw = dict(generator=generator, device=dev)
    return Draws(
        idx=torch.randint(0, arrays.n_clips + cfg.n_silence, (batch_size,), **kw),
        shift=torch.randint(-arrays.max_shift, arrays.max_shift + 1, (batch_size,), **kw),
        noise_row=torch.randint(0, arrays.n_noise, (batch_size,), **kw),
        add_u=torch.rand(batch_size, **kw),
        scale_u=torch.rand(batch_size, **kw),
    )


def kernel_operands(draws: Draws, arrays: TrainArrays, cfg: AugmentConfig) -> tuple[torch.Tensor, ...]:
    """Draws -> (clip_start, noise_start, gain, nscale, labels): the assembly kernel's per-sample operands."""
    is_silence = draws.idx >= arrays.n_clips
    safe = torch.where(is_silence, 0, draws.idx)
    labels = torch.where(is_silence, 0, arrays.labels[safe])
    clip_start = safe * arrays.row_len + arrays.pad - draws.shift * arrays.unit
    noise_start = (draws.noise_row * arrays.stride).clamp(0, arrays.noise.shape[0] - arrays.n_samples)
    gain = torch.where(is_silence, 0.0, 1.0 / 32768.0).to(torch.float32)
    add = (draws.add_u < cfg.noise_prob) | is_silence
    nscale = torch.where(add, draws.scale_u * cfg.noise_scale, 0.0).to(torch.float32)
    return clip_start, noise_start, gain, nscale, labels


def assemble_batch(draws: Draws, arrays: TrainArrays, cfg: AugmentConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Draws -> (audio (B, n_samples) float32 in [-1, 1], labels (B,) int64), via the kernel."""
    *operands, labels = kernel_operands(draws, arrays, cfg)
    return K.assemble(arrays.pool, arrays.noise, *operands, n_samples=arrays.n_samples), labels


def shard_draws(draws: Draws, rows: tuple[int, int]) -> Draws:
    """The draws of rows ``[start, stop)`` of the batch."""
    start, stop = rows
    return Draws(*(d[start:stop] for d in draws))


def sample_train_batch(
    generator: torch.Generator, arrays: TrainArrays, batch_size: int, cfg: AugmentConfig,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw and assemble one training batch on the arrays' device.

    With ``rows`` (a data-parallel rank's ``[start, stop)``), the draws are
    still the global batch's, made from the generator exactly as without,
    and only those rows are assembled: one launch of the assembly kernel on
    the shard, bitwise the same rows at any world size (JAX:
    ``sample_train_batch_pallas(data_axis=...)``).
    """
    draws = draw_batch(generator, arrays, batch_size, cfg)
    if rows is not None:
        draws = shard_draws(draws, rows)
    return assemble_batch(draws, arrays, cfg)


def eval_batch(
    audio_i16: torch.Tensor, labels: torch.Tensor, start: int, batch_size: int,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic eval batch [start, start+B), with a validity mask for the tail.

    ``rows`` ``[r0, r1)`` of the batch (a data-parallel rank's) gives only those.
    """
    n = audio_i16.shape[0]
    r0, r1 = rows if rows is not None else (0, batch_size)
    with annotate("eval_gather"):
        idx = start + torch.arange(r0, r1, device=audio_i16.device)
        valid = idx < n
        safe = torch.where(valid, idx, 0)
        return audio_i16[safe].float() / 32768.0, labels[safe], valid
