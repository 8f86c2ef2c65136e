"""ctypes binding for the native batched WAV loader (``csrc/wavpack.cc``).

The port's counterpart of ``honk_tpu.native.wavpack``. The library is built
with g++ at first use into ``honk_tpu_torch/_build/`` (listed in
``.gitignore``), under a name keyed by a hash of the source and the flags,
as ``ops/_build.py`` builds the kernels; never next to the source. Where
g++ or the load fails, or ``HONK_TPU_NO_NATIVE`` is set, ``available()`` is
False and ``load_files_packed`` returns None: the caller falls back to the
pure-Python reader (``data/wavio.py``), as the JAX package does. This is
host code: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "wavpack.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    """Where the library built from ``csrc/wavpack.cc`` goes."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwavpack-{digest}.so"


def build() -> Path:
    """Compile the library if it is not built yet; raises if g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found: the native WAV loader cannot be built on this machine")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lpthread"],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("HONK_TPU_NO_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.wavpack_load_files.restype = ctypes.c_int
        lib.wavpack_load_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_files_packed(
    paths: list[str], target_len: int, n_threads: int = 0
) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode many PCM wavs into a packed (N, target_len) int16 array.

    Returns (audio, lengths), or None if the native path is unavailable.
    Files that fail to decode get zeros and length -1 (the caller decides).
    """
    lib = _load()
    if lib is None or not paths:
        return None
    n = len(paths)
    out = np.zeros((n, target_len), dtype=np.int16)
    lengths = np.zeros(n, dtype=np.int32)
    rates = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.wavpack_load_files(
        arr,
        n,
        target_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads,
    )
    return out, lengths
