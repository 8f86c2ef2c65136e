"""Minimal WAV read/write for 16-bit PCM 16 kHz mono.

A copy of ``honk_tpu.data.wavio`` (numpy and the stdlib only). Reading
returns float32 in [-1, 1] with the same int16/32768 scaling librosa uses
for PCM16. The corpus loader decodes clips with the native batched reader
(``native/wavpack.py``) where it builds, and with this reader where it
does not: both give the same int16 arrays.
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_wav(path: str, expected_sr: int | None = 16000) -> tuple[np.ndarray, int]:
    """Read a PCM wav. Returns (float32 samples in [-1,1] mono, sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if expected_sr is not None and sr != expected_sr:
        raise ValueError(f"{path}: sample rate {sr} != expected {expected_sr}")
    return data, sr


def read_wav_int16(path: str, expected_sr: int | None = 16000) -> np.ndarray:
    """Read a PCM16 wav as raw int16 (the packed on-device storage dtype)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width != 2:
        data, _ = read_wav(path, expected_sr)
        return (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    data = np.frombuffer(raw, dtype="<i2")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1).astype(np.int16)
    if expected_sr is not None and sr != expected_sr:
        raise ValueError(f"{path}: sample rate {sr} != expected {expected_sr}")
    return data


def write_wav(path: str, data: np.ndarray, sr: int = 16000) -> None:
    """Write float [-1,1] or int16 samples as PCM16 mono."""
    if data.dtype != np.int16:
        data = (np.clip(np.asarray(data, np.float64), -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(struct.pack(f"<{len(data)}h", *data.tolist()))
