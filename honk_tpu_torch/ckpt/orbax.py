"""Read the JAX package's Orbax checkpoints (its ``best/`` variable trees).

Counterpart of the restore in ``honk_tpu.ckpt.checkpoint`` as
``honk_tpu/serve/service.py::_load_orbax`` and ``honk_tpu/cli/train.py``'s
``--input_file`` use it. A checkpoint directory written by Orbax's
``StandardCheckpointer`` holds ``_METADATA`` (JSON: ``tree_metadata``, one
entry per leaf with its key path) and the arrays in an OCDBT key-value
store, each under its dotted key path as a zarr array, with zstd-compressed
data files and manifests. Python's standard library cannot read those, so
the reader is ``tensorstore`` (its ``zarr`` or ``zarr3`` driver over an
``ocdbt`` kvstore), imported only when a checkpoint is read; it does not
import JAX. Where ``tensorstore`` is not installed, reading raises the
refusal below. There is no other reader and no fallback.

The port writes ``.pt`` checkpoints only (``ckpt.checkpoint``); this module
only reads. Orbax step directories (a JAX run's resume payload, with its
optimizer state) are not read: a port run resumes from its own ``.pt``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

REFUSAL = (
    "is an Orbax checkpoint of the JAX package; reading it needs the tensorstore "
    "package, which is not installed here (the port's own checkpoints are .pt files)"
)


def resolve(path: str) -> str:
    """The checkpoint directory ``path`` names.

    As the JAX package resolves it (``_load_orbax``, ``_load_variables``):
    a directory holding ``best/`` means its ``best``, a run's output
    directory; otherwise ``path`` itself. The JAX package would look for
    ``<path>/best`` inside a ``best/`` given directly; the port reads the
    directory it is given.
    """
    best = os.path.join(path, "best")
    return best if os.path.isdir(best) else path


def check(path: str) -> str:
    """The checkpoint directory ``path`` resolves to (``resolve``), once it can
    be read here: raises ``RuntimeError`` with ``REFUSAL`` where
    ``tensorstore`` does not import (whatever ``path`` holds), then
    ``FileNotFoundError`` where it holds no checkpoint (no ``_METADATA``).
    ``load_orbax`` reads through it, and the CLIs call it to refuse an
    unreadable checkpoint before any work."""
    try:
        import tensorstore  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"{path!r} {REFUSAL}") from e
    directory = os.path.abspath(resolve(path))
    if not os.path.isfile(os.path.join(directory, "_METADATA")):
        raise FileNotFoundError(f"{path!r} holds no Orbax checkpoint (no {directory}/_METADATA)")
    return directory


def load_orbax(path: str) -> dict[str, Any]:
    """``{"params": ..., "batch_stats": ...}`` nested dicts of numpy arrays from an Orbax checkpoint.

    ``path`` is resolved and refused as ``check`` does; a leaf that is
    neither an array nor an empty subtree raises ``ValueError``.
    """
    directory = check(path)
    import tensorstore as ts

    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    kvstore = {"driver": "ocdbt", "base": f"file://{directory}/"}
    tree: dict[str, Any] = {}
    for leaf in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        value = leaf["value_metadata"]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if value["value_type"] == "Dict" and value.get("skip_deserialize"):
            node[keys[-1]] = {}  # an empty subtree: a CNN's batch_stats
            continue
        if value["value_type"] not in ("np.ndarray", "jax.Array"):
            raise ValueError(f"{path!r}: leaf {'/'.join(keys)} is a {value['value_type']}, not an array")
        spec = {"driver": driver, "kvstore": kvstore, "path": ".".join(keys)}
        node[keys[-1]] = np.asarray(ts.open(spec, open=True, read=True).result().read().result())
    return tree
