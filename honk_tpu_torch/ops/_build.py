"""Build ``ops/csrc/*.cu`` with nvcc into shared libraries loaded with ctypes.

Each source has a plain C interface (pointers, ints and a stream; the
function returns the ``cudaError_t`` of its launch), so it compiles in
seconds without PyTorch's headers. A library is built at first use, into
``honk_tpu_torch/_build/`` (listed in ``.gitignore``), under a name keyed by
a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused. Each kernel is one self-contained ``.cu`` that
includes only the CUDA toolkit's headers, so that hash covers everything
its library is built from; a shared ``csrc/*.cuh`` would have to join the
hash of every source that includes it. ``build`` starts one nvcc per
source, all at once.

No ``--use_fast_math``: the MFCC kernel's masked log must be ``logf``, and
every kernel here is held to float32 parity gates.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): "
        "the CUDA kernels of honk_tpu_torch cannot be built on this machine"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` goes."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, str]:
    """Compile the named sources that are not built yet, one nvcc each, in parallel.

    Returns the compiler's output per source built now (``-Xptxas -v``
    reports registers and shared memory); raises ``RuntimeError`` if any
    nvcc fails, after every started nvcc has ended.
    """
    with _lock:
        todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = {}, []
        for name, out, tmp, proc in procs:
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(name)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[n] for n in failed)
            )
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build(name)
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")
