"""Minimal SRT / WebVTT caption parsers (no third-party deps).

A copy of ``honk_tpu.datagen.srt`` (the port imports nothing of the JAX
package). The reference uses ``pysrt`` (keyword_spotting_data_generator);
a small parser for the two formats YouTube serves stands in for it. Only
the fields the generator needs are kept: start/end seconds and text.
"""

from __future__ import annotations

import re
from typing import NamedTuple


class Caption(NamedTuple):
    start: float  # seconds
    end: float  # seconds
    text: str


_SRT_TIME = re.compile(
    r"(\d+):(\d\d):(\d\d)[,.](\d{1,3})\s*-->\s*(\d+):(\d\d):(\d\d)[,.](\d{1,3})"
)
# VTT allows MM:SS.mmm (no hours) as well as HH:MM:SS.mmm.
_VTT_TIME = re.compile(
    r"(?:(\d+):)?(\d\d):(\d\d)\.(\d{1,3})\s*-->\s*(?:(\d+):)?(\d\d):(\d\d)\.(\d{1,3})"
)
_TAG = re.compile(r"<[^>]+>")  # VTT inline tags like <c> / <00:00:01.000>


def _secs(h, m, s, ms) -> float:
    return int(h or 0) * 3600 + int(m) * 60 + int(s) + int(ms.ljust(3, "0")) / 1000.0


def parse_srt(text: str) -> list[Caption]:
    """Parse SubRip captions. Tolerates missing indices and CRLF."""
    captions: list[Caption] = []
    blocks = re.split(r"\n\s*\n", text.replace("\r\n", "\n").strip())
    for block in blocks:
        lines = [ln.strip() for ln in block.split("\n") if ln.strip()]
        if not lines:
            continue
        # Optional numeric index line before the timing line.
        if lines and lines[0].isdigit():
            lines = lines[1:]
        if not lines:
            continue
        m = _SRT_TIME.search(lines[0])
        if m is None:
            continue
        g = m.groups()
        start, end = _secs(g[0], g[1], g[2], g[3]), _secs(g[4], g[5], g[6], g[7])
        body = " ".join(lines[1:]).strip()
        if body:
            captions.append(Caption(start, end, body))
    return captions


def parse_vtt(text: str) -> list[Caption]:
    """Parse WebVTT captions (the format YouTube auto-captions download as)."""
    captions: list[Caption] = []
    text = text.replace("\r\n", "\n")
    blocks = re.split(r"\n\s*\n", text.strip())
    for block in blocks:
        lines = [ln for ln in block.split("\n") if ln.strip()]
        if not lines or lines[0].startswith(("WEBVTT", "NOTE", "STYLE", "REGION")):
            continue
        ti = 0
        m = _VTT_TIME.search(lines[0])
        if m is None and len(lines) > 1:  # optional cue identifier line
            ti = 1
            m = _VTT_TIME.search(lines[1])
        if m is None:
            continue
        g = m.groups()
        start, end = _secs(g[0], g[1], g[2], g[3]), _secs(g[4], g[5], g[6], g[7])
        body = _TAG.sub("", " ".join(lines[ti + 1 :])).strip()
        if body:
            captions.append(Caption(start, end, body))
    return captions


def parse_captions(text: str) -> list[Caption]:
    """Auto-detect SRT vs VTT."""
    if text.lstrip().startswith("WEBVTT"):
        return parse_vtt(text)
    return parse_srt(text)
