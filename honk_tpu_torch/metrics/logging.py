"""Structured metrics: stdout + JSONL sink (counterpart of ``honk_tpu.metrics.logging``).

One record per event, ``{"kind": ..., "t": seconds since the logger was
made, **fields}``, written as one JSON line to the sink and as
``[kind] k=v ...`` to the stream, in the JAX package's format. Under a
multi-process run only rank 0 writes (``parallel.is_primary``).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, TextIO

from ..parallel import is_primary


class MetricsLogger:
    def __init__(self, jsonl_path: str | None = None, stream: TextIO = sys.stdout):
        self._stream = stream
        self._primary = is_primary()
        self._file = open(jsonl_path, "a", buffering=1) if jsonl_path and self._primary else None
        self._t0 = time.time()

    def log(self, kind: str, **fields: Any) -> None:
        if not self._primary:
            return
        rec = {"kind": kind, "t": round(time.time() - self._t0, 3), **_to_py(fields)}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
        pretty = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in rec.items() if k != "kind"
        )
        print(f"[{kind}] {pretty}", file=self._stream, flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()


def _to_py(fields: dict[str, Any]) -> dict[str, Any]:
    out = {}
    for k, v in fields.items():
        if hasattr(v, "item"):
            v = v.item()
        if isinstance(v, float):
            v = round(v, 6)
        out[k] = v
    return out
