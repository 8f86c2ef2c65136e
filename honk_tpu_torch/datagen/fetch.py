"""Video/audio acquisition sources for the dataset generator.

A copy of ``honk_tpu.datagen.fetch``. The reference's generator couples
YouTube scraping (pytube/youtube-dl + ffmpeg) directly into the pipeline;
here acquisition is a pluggable ``VideoSource`` so the
alignment/extraction/quality stages run offline:

- ``LocalFileSource``: WAV + caption files already on disk (tests, or
  any corpus downloaded elsewhere).
- ``YouTubeSource``: declared interface for the network path; raises
  ``RuntimeError`` with an actionable message when the downloader or the
  network is missing.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple, Protocol

import numpy as np

from ..data.wavio import read_wav
from .srt import Caption, parse_captions


class VideoItem(NamedTuple):
    source_id: str  # stable id; becomes the split-hash key for all its clips
    audio: np.ndarray  # (n,) float32 mono 16 kHz
    captions: list[Caption]


class VideoSource(Protocol):
    def __iter__(self) -> Iterator[VideoItem]: ...


class LocalFileSource:
    """Pairs of (<stem>.wav, <stem>.srt|.vtt) under a directory."""

    def __init__(self, root: str, sr: int = 16000):
        self.root = root
        self.sr = sr

    def __iter__(self) -> Iterator[VideoItem]:
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".wav"):
                continue
            stem = name[:-4]
            cap_path = None
            for ext in (".srt", ".vtt"):
                p = os.path.join(self.root, stem + ext)
                if os.path.exists(p):
                    cap_path = p
                    break
            if cap_path is None:
                continue
            audio, _ = read_wav(os.path.join(self.root, name), expected_sr=self.sr)
            with open(cap_path, encoding="utf-8", errors="replace") as f:
                captions = parse_captions(f.read())
            yield VideoItem(stem, audio, captions)


class YouTubeSource:
    """Caption-filtered YouTube acquisition (network path).

    Matches the reference generator's role: search videos whose captions
    contain the target keywords, download audio, decode to 16 kHz mono.
    Requires network access plus a downloader (yt-dlp/pytube) and an
    audio decoder (ffmpeg); construction probes for them and fails with
    an actionable error instead of deep-stack ImportErrors mid-run.
    """

    def __init__(self, keywords: list[str], max_videos: int = 50, sr: int = 16000):
        self.keywords = keywords
        self.max_videos = max_videos
        self.sr = sr
        self._downloader = self._probe()

    @staticmethod
    def _probe():
        import importlib
        import shutil

        for mod in ("yt_dlp", "pytube"):
            try:
                return importlib.import_module(mod)
            except ImportError:
                continue
        raise RuntimeError(
            "YouTubeSource needs a downloader (yt-dlp or pytube) and network "
            "access; neither is available in this environment. Use "
            "LocalFileSource over pre-downloaded (wav, srt/vtt) pairs instead."
            + ("" if shutil.which("ffmpeg") else " (ffmpeg is also missing.)")
        )

    def __iter__(self) -> Iterator[VideoItem]:
        raise RuntimeError(
            "YouTubeSource download loop requires network access "
            "(unavailable here). Acquire (wav, captions) pairs offline and "
            "use LocalFileSource."
        )
