"""Streaming keyword detection (counterpart of ``honk_tpu.stream``)."""

from .streamer import (  # noqa: F401
    BatchStreamer,
    Detection,
    DetectorState,
    StreamDetector,
    Streamer,
    StreamState,
    detect,
    detect_step,
    detect_stream,
    frame_mfccs,
    smooth_posteriors,
    stream_file,
)
