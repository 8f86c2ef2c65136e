"""The port's own Orbax reader (``ckpt.ocdbt``, ``ckpt.zstd``, ``ckpt.orbax``) against tensorstore and zstandard.

While the port reads, ``sys.modules`` maps ``tensorstore``, ``zstandard``
and ``numcodecs`` to None, so an import of any of them inside the port
raises; the test itself imports ``tensorstore`` and ``zstandard`` first, as
its oracles. Held, for all 14 committed ``best/`` directories: the OCDBT
key list and every value's bytes against tensorstore's ``ocdbt`` kvstore,
and every zstd frame in them against zstandard. Held on stores that
tensorstore writes here: a b-tree of several levels, and zarr arrays of
several chunks, edge chunks, missing chunks and other dtypes. Refused: a
flipped byte (by the checksum), and every zarr or Orbax field the reader
does not read, by name.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts
import zstandard

from honk_tpu_torch.ckpt import load_orbax, zstd
from honk_tpu_torch.ckpt.ocdbt import MANIFEST_MAGIC, NODE_MAGIC, OcdbtStore, crc32c
from honk_tpu_torch.ckpt.orbax import read_zarr

ROOT = Path(__file__).resolve().parents[1]
BEST = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("zoo*/*/best"))
HIDDEN = ("tensorstore", "zstandard", "numcodecs")


@pytest.fixture
def hidden(monkeypatch):
    """A context in which importing tensorstore, zstandard or numcodecs raises ImportError."""

    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m:
            for name in HIDDEN:
                m.setitem(sys.modules, name, None)
            yield

    return ctx


def _kvstore(directory):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(directory)}/"}).result()


def _oracle(directory):
    kv = _kvstore(directory)
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _unzstd(frame: bytes) -> bytes:
    return zstandard.ZstdDecompressor().decompressobj().decompress(frame)


def test_crc32c_check_value():
    assert crc32c(b"123456789") == 0xE3069283  # the catalogued check value of CRC-32C


@pytest.mark.parametrize("best", BEST)
def test_keys_and_values_equal_tensorstores_kvstore(best, hidden):
    want = _oracle(ROOT / best)
    with hidden():
        store = OcdbtStore(str(ROOT / best))
        got = {k: store.read(k) for k in store.list()}
        assert store.read(b"no such key") is None
    assert list(got) == sorted(want) and len(got) > 10
    for k, v in want.items():
        assert got[k] == v, k


def _frames(directory):
    """Every zstd frame of a directory: each manifest's and node file's body, and each zarr chunk."""
    frames = {}
    for path in sorted(Path(directory).rglob("*")):
        blob = path.read_bytes() if path.is_file() else b""
        if blob[:4] in (MANIFEST_MAGIC.to_bytes(4, "big"), NODE_MAGIC.to_bytes(4, "big")):
            assert blob[12:14] == b"\x00\x01"  # version 0, zstd
            frames[str(path.relative_to(directory))] = blob[14:-4]
    for key, value in _oracle(directory).items():
        if not key.endswith(b".zarray"):
            frames[key.decode()] = value
    return frames


@pytest.mark.parametrize("best", BEST)
def test_every_zstd_frame_decodes_equal_to_zstandard(best, hidden):
    frames = _frames(ROOT / best)
    want = {name: _unzstd(frame) for name, frame in frames.items()}
    assert sum(name.endswith("manifest.ocdbt") for name in frames) == 2
    with hidden():
        for name, frame in frames.items():
            assert zstd.decompress(frame) == want[name], name
            assert zstd.decompress(frame, len(want[name])) == want[name], name


def _frame(kind):
    rng = np.random.default_rng(0)
    text = b"".join(b"keyword %d spotted at %d ms\n" % (i % 37, i * 10) for i in range(20000))
    if kind == "empty":
        return b"", zstandard.ZstdCompressor().compress(b"")
    if kind.startswith("level"):
        return text, zstandard.ZstdCompressor(level=int(kind[5:])).compress(text)
    if kind == "checksum":
        return text, zstandard.ZstdCompressor(write_checksum=True).compress(text)
    if kind == "no_content_size_over_128k":  # as a stream writes it: several blocks, no size in the header
        data = text * 2
        c = zstandard.ZstdCompressor(write_content_size=False).compressobj()
        return data, c.compress(data) + c.flush()
    if kind == "raw_and_rle":  # incompressible bytes make raw blocks, a run of one byte an RLE block
        data = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes() + b"\x07" * 300_000
        return data, zstandard.ZstdCompressor(level=3).compress(data)
    if kind == "two_frames":
        c = zstandard.ZstdCompressor()
        return text + b"tail", c.compress(text) + c.compress(b"tail")
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["empty", "level1", "level3", "level19", "checksum",
                                  "no_content_size_over_128k", "raw_and_rle", "two_frames"])
def test_frames_zstandard_makes_decode(kind, hidden):
    data, frame = _frame(kind)
    with hidden():
        assert zstd.decompress(frame) == data
        assert zstd.decompress(frame, len(data)) == data


def test_a_corrupt_truncated_or_missized_frame_raises(hidden):
    data, frame = _frame("checksum")
    bad = bytearray(frame)
    bad[-2] ^= 0xFF  # the content checksum
    with hidden():
        with pytest.raises(ValueError, match="corrupt zstd frame"):
            zstd.decompress(bytes(bad))
        with pytest.raises(ValueError, match="truncated zstd frame"):
            zstd.decompress(frame[: len(frame) // 2])
        with pytest.raises(ValueError, match="not the 5 expected"):
            zstd.decompress(frame, 5)


def _copy(tmp_path, best="zoo/res8/best"):
    out = tmp_path / "best"
    shutil.copytree(ROOT / best, out)
    return out


@pytest.mark.parametrize("name", ["manifest.ocdbt", "ocdbt.process_0/manifest.ocdbt", "d"])
def test_a_flipped_byte_is_refused_by_the_checksum(name, tmp_path, hidden):
    copy = _copy(tmp_path)
    path = next((copy / "d").iterdir()) if name == "d" else copy / name
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    path.write_bytes(bytes(blob))
    with hidden():
        if name.startswith("ocdbt.process_0"):  # the root store does not read its processes' manifests
            OcdbtStore(str(copy))
            with pytest.raises(ValueError, match="CRC-32C mismatch"):
                OcdbtStore(str(copy / "ocdbt.process_0"))
        else:
            with pytest.raises(ValueError, match="CRC-32C mismatch"):
                OcdbtStore(str(copy))


def test_a_multi_level_btree_equals_tensorstore(tmp_path, hidden, monkeypatch):
    """Small nodes force interior nodes several levels deep, with shared key prefixes."""
    base = str(tmp_path / "store")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{base}/",
                          "config": {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 24}}).result()
    rng = np.random.default_rng(1)
    with ts.Transaction() as txn:
        for i in range(120):
            kv.with_transaction(txn).write(f"params.conv{i % 7}.kernel/{i:04d}".encode(),
                                           rng.bytes(int(rng.integers(0, 60)))).result()
    kv.write(b"params.output.bias/0", b"last commit").result()
    want = _oracle(base)
    heights, walk = [], OcdbtStore._walk

    def counted(self, ref, height, prefix):
        heights.append(height)
        walk(self, ref, height, prefix)

    monkeypatch.setattr(OcdbtStore, "_walk", counted)
    with hidden():
        store = OcdbtStore(base)
        got = {k: store.read(k) for k in store.list()}
    assert max(heights) >= 2 and len(got) == 121
    assert got == want


def _zarr(base, path, data, **meta):
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{base}/"}, "path": path,
            "metadata": {"compressor": {"id": "zstd", "level": 1}, "dtype": data.dtype.str,
                         "shape": list(data.shape), **meta}}
    arr = ts.open(spec, create=True).result()
    arr.write(data).result()


@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", "<i8", "|u1", "|b1", "<f2"])
def test_zarr_arrays_of_several_chunks_equal_tensorstores(dtype, tmp_path, hidden):
    base = str(tmp_path / "store")
    data = (np.random.default_rng(2).standard_normal((7, 10, 3)) * 50).astype(dtype)
    data[:4, :4] = 0  # a whole chunk equal to fill_value is not written
    _zarr(base, "a", data, chunks=[4, 4, 2], fill_value=np.zeros((), dtype).item())
    _zarr(base, "scalar", np.asarray(3, dtype), fill_value=None)
    keys = _kvstore(base).list().result()
    assert b"a/0.0.0" not in keys and b"a/1.2.1" in keys  # a missing chunk and an edge chunk
    with hidden():
        store = OcdbtStore(base)
        got, scalar = read_zarr(store, "a"), read_zarr(store, "scalar")
    assert got.dtype == scalar.dtype == data.dtype and scalar.shape == () and scalar == np.asarray(3, dtype)
    np.testing.assert_array_equal(got, data)


def _store_with_zarray(tmp_path, **changes):
    base = str(tmp_path / "store")
    data = np.arange(6, dtype="<f4")
    _zarr(base, "a", data, chunks=[6], fill_value=None)
    kv = _kvstore(base)
    meta = json.loads(kv.read(b"a/.zarray").result().value)
    meta.update(changes)
    kv.write(b"a/.zarray", json.dumps(meta).encode()).result()
    return base


@pytest.mark.parametrize("changes,field", [
    ({"zarr_format": 3}, "zarr_format 3"),
    ({"compressor": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}}, "compressor"),
    ({"order": "F"}, "order 'F'"),
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"dimension_separator": "/"}, "dimension_separator"),
    ({"dtype": "<U2"}, "dtype '<U2'"),
])
def test_a_zarray_field_not_read_is_refused_by_name(changes, field, tmp_path, hidden):
    base = _store_with_zarray(tmp_path, **changes)
    with hidden(), pytest.raises(ValueError, match=field):
        read_zarr(OcdbtStore(base), "a")


def test_a_missing_chunk_with_a_null_fill_value_raises(tmp_path, hidden):
    base = str(tmp_path / "store")
    meta = {"chunks": [6], "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".", "dtype": "<f4",
            "fill_value": None, "filters": None, "order": "C", "shape": [6], "zarr_format": 2}
    _kvstore(base).write(b"a/.zarray", json.dumps(meta).encode()).result()  # and no chunk
    with hidden():
        store = OcdbtStore(base)
        assert store.read(b"a/0") is None and store.read(b"a/.zarray") is not None
        with pytest.raises(ValueError, match="fill_value is null"):
            read_zarr(store, "a")


@pytest.mark.parametrize("changes,field", [({"use_zarr3": True}, "use_zarr3"), ({"use_ocdbt": False}, "use_ocdbt")])
def test_an_orbax_layout_not_read_is_refused_by_name(changes, field, tmp_path, hidden):
    copy = _copy(tmp_path)
    meta = json.loads((copy / "_METADATA").read_text())
    (copy / "_METADATA").write_text(json.dumps({**meta, **changes}))
    with hidden(), pytest.raises(ValueError, match=field):
        load_orbax(str(copy))


def test_the_port_reads_every_directory_importing_none_of_them():
    """In a fresh process: all 14 directories load equal to their .pt, and
    nothing of tensorstore, zstandard, numcodecs, JAX or the JAX package is imported."""
    code = (
        "import sys, torch\n"
        "from honk_tpu_torch.ckpt import read_state_dict\n"
        f"for best in {BEST!r}:\n"
        "    got = read_state_dict(best)\n"
        "    pt = torch.load(best[:-len('/best')] + '.pt', weights_only=True)\n"
        "    pt = {k: v for k, v in pt.items() if not k.endswith('.num_batches_tracked')}\n"
        "    assert got.keys() == pt.keys() and all(torch.equal(got[k], pt[k]) for k in pt), best\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {(*HIDDEN, 'jax', 'jaxlib', 'honk_tpu')!r}]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
