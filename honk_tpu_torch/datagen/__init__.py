"""Keyword-spotting dataset generator from captioned long-form audio.

Counterpart of ``honk_tpu.datagen`` (the reference's
``keyword_spotting_data_generator/``, Jaejun Lee's YouTube caption-based
KWS data pipeline): find target keywords in captions, align caption
timestamps to word level, extract ~1 s clips per occurrence, and score
the clips with a trained model.

- The caption, alignment and extraction stages are host numpy, copied from
  the JAX package, so the clip files are the same bytes.
- Acquisition is a pluggable ``VideoSource``: ``LocalFileSource`` reads
  (wav, srt/vtt) pairs from disk; ``YouTubeSource`` refuses with an
  actionable error where no downloader or network is present.
- ``evaluate_clips`` replaces the reference's human labeling UI: a trained
  checkpoint labels every clip in batches on the card (the MFCC kernel,
  then the model's eval forward) and the report gives per-keyword
  acceptance.
"""

from .align import KeywordOccurrence, find_keyword_occurrences  # noqa: F401
from .extract import ExtractedClip, extract_clips, write_clips  # noqa: F401
from .fetch import LocalFileSource, VideoSource, YouTubeSource  # noqa: F401
from .quality import evaluate_clips  # noqa: F401
from .srt import Caption, parse_captions, parse_srt, parse_vtt  # noqa: F401
