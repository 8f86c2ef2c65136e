"""Audio snippet utilities: energy-window trimming and padding.

The part of ``honk_tpu.audio.snippet.AudioSnippet`` that serving uses
(``trim_window`` and ``pad_to``), copied so the port imports nothing of the
JAX package. Amplitude trimming, chunking and ``generate_contrastive`` come
with the personalization slice.
"""

from __future__ import annotations

import numpy as np


class AudioSnippet:
    """Mutable wrapper over float32 mono samples in [-1, 1]."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, dtype=np.float32)

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

    def pad_to(self, size: int = 16000) -> "AudioSnippet":
        if len(self.data) < size:
            self.data = np.pad(self.data, (0, size - len(self.data)))
        return self

    def __len__(self) -> int:
        return len(self.data)
