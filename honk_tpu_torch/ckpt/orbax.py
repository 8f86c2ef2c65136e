"""Read the JAX package's Orbax checkpoints (its ``best/`` variable trees).

Counterpart of the restore in ``honk_tpu.ckpt.checkpoint`` as
``honk_tpu/serve/service.py::_load_orbax`` and ``honk_tpu/cli/train.py``'s
``--input_file`` use it. A checkpoint directory written by Orbax's
``StandardCheckpointer`` holds ``_METADATA`` (JSON: ``tree_metadata``, one
entry per leaf with its key path) and the arrays in an OCDBT key-value
store, each under its dotted key path as a zarr v2 array: a ``.zarray``
(JSON) and its chunks, each a zstd frame. The port reads all of it itself,
on the host: ``ckpt.ocdbt`` reads the store, ``ckpt.zstd`` decodes the
frames through the system's ``libzstd``, and this module reads the zarr
arrays and walks the tree. It needs no ``tensorstore``, ``zstandard`` or
JAX.

What Orbax writes for these trees is read: ``use_ocdbt``, zarr format 2,
the zstd compressor, no filters, C order, the ``.`` separator and numeric
dtypes. Anything else raises a ``ValueError`` that names the field.

The port writes ``.pt`` checkpoints only (``ckpt.checkpoint``); this module
only reads. Orbax step directories (a JAX run's resume payload, with its
optimizer state) are not read: a port run resumes from its own ``.pt``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any

import numpy as np

from . import zstd
from .ocdbt import OcdbtStore


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
    """The checkpoint directory ``path`` resolves to (``resolve``); raises
    ``FileNotFoundError`` where it holds no checkpoint (no ``_METADATA``).
    ``load_orbax`` reads through it, and the CLIs call it to refuse a
    missing checkpoint before any work."""
    directory = os.path.abspath(resolve(path))
    if not os.path.isfile(os.path.join(directory, "_METADATA")):
        raise FileNotFoundError(
            f"{path!r} is neither a .pt file nor an Orbax checkpoint directory: "
            f"it holds no Orbax checkpoint (no {directory}/_METADATA)")
    return directory


def _fill(value: Any, dtype: np.dtype, where: str) -> np.ndarray:
    if value is None:
        raise ValueError(f"{where}: a chunk is missing and fill_value is null")
    if isinstance(value, str):  # zarr v2 spells non-finite floats as strings
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}.get(value, value)
    return np.array(value, dtype=dtype)


def read_zarr(store: OcdbtStore, path: str) -> np.ndarray:
    """The zarr v2 array under ``path`` in ``store``."""
    raw = store.read(f"{path}/.zarray".encode())
    if raw is None:
        raise ValueError(f"{store.directory}: no array {path!r} (no {path}/.zarray)")
    meta = json.loads(raw)
    where = f"{store.directory}: {path}/.zarray"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')!r}; only 2 is read")
    compressor = meta.get("compressor")
    if not isinstance(compressor, dict) or compressor.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {compressor!r}; only zstd is read")
    if meta.get("filters") is not None:
        raise ValueError(f"{where}: filters {meta['filters']!r}; only null is read")
    if meta.get("order") != "C":
        raise ValueError(f"{where}: order {meta.get('order')!r}; only C is read")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{where}: dimension_separator {meta['dimension_separator']!r}; only '.' is read")
    try:
        dtype = np.dtype(meta["dtype"])
    except (TypeError, ValueError) as e:
        raise ValueError(f"{where}: dtype {meta['dtype']!r} is not supported") from e
    if dtype.kind not in "biuf":
        raise ValueError(f"{where}: dtype {meta['dtype']!r} is not supported (only bool, int, uint, float)")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape):
        raise ValueError(f"{where}: chunks {list(chunks)} for shape {list(shape)}")
    out = np.empty(shape, dtype)
    grid = [range(math.ceil(n / c)) for n, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        name = ".".join(map(str, index)) if index else "0"
        frame = store.read(f"{path}/{name}".encode())
        window = tuple(slice(i * c, min((i + 1) * c, n)) for i, c, n in zip(index, chunks, shape))
        if frame is None:
            out[window] = _fill(meta.get("fill_value"), dtype, where)
            continue
        block = np.frombuffer(zstd.decompress(frame, math.prod(chunks) * dtype.itemsize), dtype).reshape(chunks)
        out[window] = block[tuple(slice(0, w.stop - w.start) for w in window)]
    return out.astype(dtype.newbyteorder("="), copy=False)


def load_orbax(path: str) -> dict[str, Any]:
    """``{"params": ..., "batch_stats": ...}`` nested dicts of numpy arrays from an Orbax checkpoint.

    ``path`` is resolved and refused as ``check`` does; a leaf that is
    neither an array nor an empty subtree raises ``ValueError``.
    """
    directory = check(path)
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path!r}: use_zarr3 is set; only zarr format 2 is read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path!r}: use_ocdbt is not set; only an OCDBT store is read")
    store = OcdbtStore(directory)
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
        node[keys[-1]] = read_zarr(store, ".".join(keys))
    return tree
