"""Audio snippet utilities: amplitude trimming, chunking, contrastive examples.

A copy of ``honk_tpu.audio.snippet.AudioSnippet`` (reference
``utils/manage_audio.py::AudioSnippet``), so the port imports nothing of the
JAX package: a host-side helper over float32 mono audio with RMS-window
start/end trimming (``cli/manage_audio.py``), the max-energy window
(``trim_window``: serving, personalization, ``datagen``), fixed-size
chunking, padding, and ``generate_contrastive``, the scrambled and partial
copies of a positive that ``TrainingService`` uses as negatives. Every
method gives the JAX class's arrays bit for bit.
"""

from __future__ import annotations

import numpy as np


class AudioSnippet:
    """Mutable wrapper over float32 mono samples in [-1, 1]."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, dtype=np.float32)

    def copy(self) -> "AudioSnippet":
        return AudioSnippet(self.data.copy())

    # -- trimming ---------------------------------------------------------
    def _window_rms(self, window: int) -> np.ndarray:
        n = len(self.data) // window
        if n == 0:
            return np.zeros(0, np.float32)
        x = self.data[: n * window].reshape(n, window)
        return np.sqrt((x**2).mean(axis=1))

    def ltrim(self, threshold: float = 0.01, window: int = 160) -> "AudioSnippet":
        """Drop leading audio quieter than `threshold` RMS (in-place)."""
        rms = self._window_rms(window)
        idx = np.nonzero(rms >= threshold)[0]
        start = int(idx[0]) * window if len(idx) else len(self.data)
        self.data = self.data[start:]
        return self

    def rtrim(self, threshold: float = 0.01, window: int = 160) -> "AudioSnippet":
        """Drop trailing audio quieter than `threshold` RMS (in-place)."""
        rms = self._window_rms(window)
        idx = np.nonzero(rms >= threshold)[0]
        end = (int(idx[-1]) + 1) * window if len(idx) else 0
        self.data = self.data[:end]
        return self

    def trim(self, threshold: float = 0.01, window: int = 160) -> "AudioSnippet":
        return self.ltrim(threshold, window).rtrim(threshold, window)

    def trim_window(self, window_size: int = 16000) -> "AudioSnippet":
        """Keep the `window_size` span with maximum energy (in-place)."""
        n = len(self.data)
        if n <= window_size:
            return self
        sq = self.data.astype(np.float64) ** 2
        cs = np.concatenate([[0.0], np.cumsum(sq)])
        energies = cs[window_size:] - cs[:-window_size]
        start = int(np.argmax(energies))
        self.data = self.data[start : start + window_size]
        return self

    # -- chunking / padding ----------------------------------------------
    def chunk(self, size: int = 16000, stride: int | None = None) -> list["AudioSnippet"]:
        stride = stride or size
        return [
            AudioSnippet(self.data[i : i + size])
            for i in range(0, max(1, len(self.data) - size + 1), stride)
        ]

    def pad_to(self, size: int = 16000) -> "AudioSnippet":
        if len(self.data) < size:
            self.data = np.pad(self.data, (0, size - len(self.data)))
        return self

    # -- contrastive negatives -------------------------------------------
    def generate_contrastive(self, n: int = 8, seed: int = 0) -> list["AudioSnippet"]:
        """Negatives from a positive keyword clip: time-scrambled and
        partial copies that keep spectral content but break the temporal
        pattern. The shuffle draws from ``np.random.default_rng(seed)``, as
        the JAX class does, so the segments come in the same order."""
        rng = np.random.default_rng(seed)
        out: list[AudioSnippet] = []
        x = self.data
        if len(x) == 0:
            return out
        for i in range(n):
            kind = i % 4
            if kind == 0:  # shuffle coarse segments
                n_seg = 8
                seg = len(x) // n_seg
                parts = [x[j * seg : (j + 1) * seg] for j in range(n_seg)]
                rng.shuffle(parts)
                y = np.concatenate(parts + [x[n_seg * seg :]])
            elif kind == 1:  # reversed
                y = x[::-1].copy()
            elif kind == 2:  # first half only, rest silence
                y = np.concatenate([x[: len(x) // 2], np.zeros(len(x) - len(x) // 2, np.float32)])
            else:  # second half only
                y = np.concatenate([np.zeros(len(x) // 2, np.float32), x[len(x) // 2 :]])
            out.append(AudioSnippet(y))
        return out

    def __len__(self) -> int:
        return len(self.data)
