"""Plain offline keyword search over a long recording (Honk's ``service.py`` stride logic).

Every 10 ms MFCC frame of the recording (centre framing), the 101-frame
windows every ``hop`` samples, the eval forward of each window, the
softmax, the trailing mean of the last ``smoothing_window`` posteriors (a
cumulative sum with a zero row in front, each row the difference of two of
its rows over the count), and the detections: a keyword label (not 0 or 1)
that is the argmax of the smoothed row and at least ``threshold``, at
least ``min_gap`` windows after the previous detection of any label, timed
at the start of its window.
"""

from __future__ import annotations

import numpy as np
import torch

from . import frontend
from .precision import Rounding, no_tf32


def smooth(post: torch.Tensor, w: int) -> torch.Tensor:
    n = post.shape[0]
    cs = torch.cat([torch.zeros_like(post[:1]), torch.cumsum(post, dim=0)], dim=0)
    idx = torch.arange(n, device=post.device)
    starts = (idx - w + 1).clamp_min(0)
    return (cs[idx + 1] - cs[starts]) / (idx - starts + 1).to(post.dtype)[:, None]


def detect(smoothed: np.ndarray, threshold: float, min_gap: int, hop_s: float) -> list[tuple[float, int, float]]:
    """(start s, label, score) of each detection in the smoothed posteriors."""
    events, last = [], -(10 ** 9)
    for i in range(smoothed.shape[0]):
        label = int(smoothed[i].argmax())
        score = float(smoothed[i][label])
        if label >= 2 and score >= threshold and i - last >= min_gap:
            last = i
            events.append((i * hop_s, label, score))
    return events


def search(forward, params: dict, config: dict, bn: dict, audio: torch.Tensor, stream: dict,
           rounding: Rounding = None, block: int = 512) -> torch.Tensor:
    """Smoothed posteriors (n_windows, n_labels) of one recording (float32 on its device), the
    windows' ``forward`` (the family's) ``block`` at a time."""
    hop_frames = stream["hop_samples"] // frontend.HOP
    with no_tf32(), torch.no_grad():
        feats = frontend.mfcc(audio[None])[0]
        windows = feats.unfold(0, frontend.WINDOW_FRAMES, hop_frames).transpose(1, 2)
        post = torch.cat([torch.softmax(forward(params, config, windows[i:i + block], bn=bn, rounding=rounding),
                                        dim=-1) for i in range(0, windows.shape[0], block)])
        return smooth(post, stream["smoothing_window"])
