"""Native host code of the port: the batched WAV loader (``wavpack``), built with g++ at first use."""

from . import wavpack

__all__ = ["wavpack"]
