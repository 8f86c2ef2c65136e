"""Keyword occurrence search + word-level timestamp estimation.

A copy of ``honk_tpu.datagen.align``, the caption-alignment stage of the
reference's ``keyword_spotting_data_generator``: captions give
block-level timing only, so a word's timestamp is estimated by linear
interpolation of the block duration over its words — the same
approximation the reference uses before clip extraction.
"""

from __future__ import annotations

import re
from typing import Iterable, NamedTuple

from .srt import Caption

_WORD = re.compile(r"[a-z0-9']+")


class KeywordOccurrence(NamedTuple):
    keyword: str
    start: float  # estimated word start, seconds
    end: float  # estimated word end, seconds
    caption_text: str


def _words(text: str) -> list[str]:
    return _WORD.findall(text.lower())


def find_keyword_occurrences(
    captions: Iterable[Caption],
    keywords: Iterable[str],
    min_word_s: float = 0.08,
    max_word_s: float = 1.0,
) -> list[KeywordOccurrence]:
    """Locate every keyword occurrence with interpolated word timing.

    Word k of n in a caption block [t0, t1] is assigned
    [t0 + k*(t1-t0)/n, t0 + (k+1)*(t1-t0)/n], clamped to a plausible
    spoken-word duration. Occurrences whose block timing is degenerate
    (end <= start) are dropped.
    """
    kw = {w.lower() for w in keywords}
    out: list[KeywordOccurrence] = []
    for cap in captions:
        dur = cap.end - cap.start
        if dur <= 0:
            continue
        ws = _words(cap.text)
        if not ws:
            continue
        per = dur / len(ws)
        for k, w in enumerate(ws):
            if w not in kw:
                continue
            w_start = cap.start + k * per
            w_len = min(max(per, min_word_s), max_word_s)
            out.append(KeywordOccurrence(w, w_start, w_start + w_len, cap.text))
    return out
