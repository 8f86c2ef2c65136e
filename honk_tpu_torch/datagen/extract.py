"""Clip extraction: (waveform, keyword occurrences) -> 1 s training clips.

A copy of ``honk_tpu.datagen.extract`` (on the port's ``AudioSnippet`` and
WAV writer, so the clip files are the same bytes), the ffmpeg-extraction
stage of the reference's ``keyword_spotting_data_generator``, without ffmpeg:
the source audio is already a decoded 16 kHz mono array (the fetch layer
owns decoding), so extraction is pure array slicing plus RMS-based
recentering, and clips are written in the honk/Speech Commands directory
layout (<word>/<source>_nohash_<n>.wav) so the SHA1 split logic
(data/splits.py) groups all clips of one source video into one split.
"""

from __future__ import annotations

import os
from typing import Iterable, NamedTuple

import numpy as np

from ..audio.snippet import AudioSnippet
from ..data.wavio import write_wav
from .align import KeywordOccurrence

SR = 16000
CLIP_SAMPLES = 16000


class ExtractedClip(NamedTuple):
    keyword: str
    audio: np.ndarray  # (16000,) float32 in [-1, 1]
    source_time: float  # occurrence start in the source, seconds


def extract_clips(
    audio: np.ndarray,
    occurrences: Iterable[KeywordOccurrence],
    sr: int = SR,
    recenter: bool = True,
) -> list[ExtractedClip]:
    """Cut a 1 s window around each occurrence.

    The window is centered on the occurrence midpoint; with ``recenter``
    the highest-energy 1 s sub-window of a 1.5 s context is kept instead
    (AudioSnippet.trim_window), compensating for caption-interpolation
    timing error the same way the reference's generator recenters clips.
    """
    audio = np.asarray(audio, np.float32)
    n = audio.shape[0]
    out: list[ExtractedClip] = []
    for occ in occurrences:
        mid = int((occ.start + occ.end) / 2 * sr)
        ctx = int(0.75 * sr) if recenter else CLIP_SAMPLES // 2
        lo, hi = max(0, mid - ctx), min(n, mid + ctx)
        if hi - lo < CLIP_SAMPLES // 2:  # too close to the edges to be usable
            continue
        window = audio[lo:hi]
        if recenter:
            snip = AudioSnippet(window).trim_window(CLIP_SAMPLES)
            clip = snip.data
        else:
            clip = window
        if clip.shape[0] < CLIP_SAMPLES:
            clip = np.pad(clip, (0, CLIP_SAMPLES - clip.shape[0]))
        out.append(ExtractedClip(occ.keyword, clip[:CLIP_SAMPLES], occ.start))
    return out


def write_clips(
    clips: Iterable[ExtractedClip],
    out_dir: str,
    source_id: str,
    sr: int = SR,
) -> list[str]:
    """Write clips as <out_dir>/<keyword>/<source_id>_nohash_<n>.wav.

    ``source_id`` plays the role of the Speech Commands speaker hash: the
    split hasher strips ``_nohash_<n>``, so every clip from one source
    video lands in the same train/dev/test split (no leakage).
    """
    counters: dict[str, int] = {}
    paths: list[str] = []
    for clip in clips:
        d = os.path.join(out_dir, clip.keyword)
        os.makedirs(d, exist_ok=True)
        k = counters.get(clip.keyword, 0)
        counters[clip.keyword] = k + 1
        path = os.path.join(d, f"{source_id}_nohash_{k}.wav")
        write_wav(path, clip.audio, sr)
        paths.append(path)
    return paths
