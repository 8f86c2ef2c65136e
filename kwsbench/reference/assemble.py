"""Plain batch assembly: the Honk recipe's augmentation of one training batch.

A frozen copy of the draws the port makes for train step ``step`` under run
key ``key``: a generator on the device seeded ``((key & 0xFFFFFFFF) << 32) |
step``, then, each of ``B`` values and in this order, the clip index (those
``>= n_clips`` are virtual silence slots), the time shift in ``[-ts, ts]``
samples, the noise window (starts ``stride`` samples apart), and two
uniforms: whether noise is mixed in (below ``noise_prob``, and always for
silence) and its scale (times ``noise_scale``).

The batch is then formed from the benchmark's own int16 clips and noise: a
clip shifted right by ``shift`` samples with zero fill, divided by 32768
(silence: no clip), plus the noise window times its scale, clipped to
[-1, 1]; silence is label 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Recipe(NamedTuple):
    noise_prob: float = 0.8
    timeshift_samples: int = 1600
    noise_scale: float = 0.1
    noise_stride: int = 2000
    n_samples: int = 16000


def n_noise_windows(n_noise: int, recipe: Recipe) -> int:
    """Noise windows in ``n_noise`` samples of noise (at least one clip's length)."""
    if n_noise < recipe.n_samples:
        raise ValueError(f"the noise must hold a clip's {recipe.n_samples} samples; it has {n_noise}")
    return (n_noise - recipe.n_samples) // recipe.noise_stride + 1


def draws(key: int, step: int, batch: int, n_clips: int, n_silence: int, n_noise: int, recipe: Recipe,
          device: torch.device) -> tuple[torch.Tensor, ...]:
    """(idx, shift, noise_row, add_u, scale_u) of one step's batch, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(((key & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    kw = dict(generator=g, device=device)
    ts = recipe.timeshift_samples
    return (torch.randint(0, n_clips + n_silence, (batch,), **kw),
            torch.randint(-ts, ts + 1, (batch,), **kw),
            torch.randint(0, n_noise_windows(n_noise, recipe), (batch,), **kw),
            torch.rand(batch, **kw),
            torch.rand(batch, **kw))


def batch(clips: np.ndarray, labels: np.ndarray, noise: np.ndarray, drawn: tuple[torch.Tensor, ...],
          recipe: Recipe, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(audio (B, n_samples) float32, labels (B,) int64) of the draws ``drawn``."""
    idx, shift, noise_row, add_u, scale_u = (t.cpu() for t in drawn)
    n, s = clips.shape
    silence = idx >= n
    safe = torch.where(silence, 0, idx).numpy()
    audio = torch.from_numpy(clips[safe].astype(np.float32) / 32768.0)
    t = torch.arange(s)[None, :] - shift[:, None]
    audio = torch.where((t >= 0) & (t < s), torch.gather(audio, 1, t.clamp(0, s - 1)), 0.0)
    audio = torch.where(silence[:, None], 0.0, audio)
    noise_t = torch.from_numpy(np.asarray(noise, np.float32))
    start = (noise_row * recipe.noise_stride).clamp(0, noise_t.shape[0] - s)
    window = noise_t[start[:, None] + torch.arange(s)[None, :]]
    scale = torch.where((add_u < recipe.noise_prob) | silence, scale_u * recipe.noise_scale, 0.0)
    out = (audio + window * scale[:, None]).clamp(-1.0, 1.0)
    lab = torch.where(silence, 0, torch.from_numpy(labels.astype(np.int64))[safe])
    return out.to(device), lab.to(device)
