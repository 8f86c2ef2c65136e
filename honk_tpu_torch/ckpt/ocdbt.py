"""Read an OCDBT key-value store (tensorstore's format, which Orbax writes), in plain Python.

An Orbax checkpoint directory keeps its arrays in one OCDBT store. Its
files, as tensorstore writes them:

- ``manifest.ocdbt``: the store's configuration and its versions, newest
  last. Each version names the root of a b-tree by data file, offset and
  length.
- b-tree nodes, in data files under ``d/`` (a node may also sit inside a
  data file that holds values). A node holds sorted keys, prefix-compressed.
  A leaf maps each key to a value, which is either inline or a reference
  (data file, offset, length). An interior node maps a key range to a
  child node.
- data files of values: raw bytes, values back to back, with no header.

Manifests and nodes share one framing: a big-endian magic
(``MANIFEST_MAGIC`` or ``NODE_MAGIC``), the file's length as a u64
little-endian, a format version (a varint, 0), a compression (a varint: 0
none, 1 zstd), the body (one zstd frame where compressed) and a CRC-32C
of everything before it, u32 little-endian. Integers inside a body are
LEB128 varints unless said otherwise, and a node stores each field as a
column over its entries.

Orbax writes one store per process (``ocdbt.process_<i>/``) and merges
them into the directory's root store. The root manifest's b-tree refers to
the processes' data files by paths relative to the directory, so reading
from the root manifest reaches every key. Data file paths are held as a
base path and a relative path. A node found through a data file id takes
that id's base path in front of the base paths in its own table.

``OcdbtStore(directory)`` reads the newest version. Only a manifest of the
kind ``single`` (the manifest holds the versions itself) is read, as Orbax
writes it; ``numbered`` manifests raise.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
HEADER_BYTES = 12  # the magic (u32 big-endian) and the file's length (u64 little-endian)


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), as OCDBT checksums its files."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Reads fields off a decoded body, raising ``ValueError`` past its end."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: ends inside a field ({n} bytes at {self.pos} of {len(self.data)})")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: a varint longer than 64 bits at {self.pos}")

    def column(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def unframe(blob: bytes, magic: int, what: str) -> bytes:
    """The decoded body of a manifest or node file: checks the magic, the length,
    the CRC-32C, the version and the compression, then decompresses."""
    if len(blob) < HEADER_BYTES + 4:
        raise ValueError(f"{what}: {len(blob)} bytes is too short for an OCDBT file")
    got_magic = struct.unpack_from(">I", blob)[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, not {magic:#010x}")
    length = struct.unpack_from("<Q", blob, 4)[0]
    if length != len(blob):
        raise ValueError(f"{what}: the header gives {length} bytes, the file has {len(blob)}")
    stored = struct.unpack_from("<I", blob, len(blob) - 4)[0]
    if crc32c(blob[:-4]) != stored:
        raise ValueError(f"{what}: CRC-32C mismatch (stored {stored:#010x}, computed {crc32c(blob[:-4]):#010x})")
    r = _Reader(blob[: len(blob) - 4], what)
    r.pos = HEADER_BYTES
    version = r.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"{what}: OCDBT format version {version}, only {FORMAT_VERSION} is read")
    compression = r.varint()
    body = r.data[r.pos:]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"{what}: compression {compression} is neither 0 (none) nor 1 (zstd)")


@dataclass(frozen=True)
class Ref:
    """Bytes ``[offset, offset + length)`` of the data file at ``base + relative`` in the store's directory."""

    base: str
    relative: str
    offset: int
    length: int


def _data_file_table(r: _Reader, base: str) -> list[tuple[str, str]]:
    """The (base path, relative path) of each data file a manifest or node names,
    with ``base`` (the holding file's base path) in front of every base path."""
    n = r.varint()
    prefix = [0, *r.column(n - 1)] if n else []
    suffix = r.column(n)
    base_len = r.column(n)
    files, previous = [], b""
    for i in range(n):
        if prefix[i] > len(previous):
            raise ValueError(f"{r.what}: data file {i} shares {prefix[i]} bytes of a {len(previous)}-byte path")
        path = previous[: prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"{r.what}: data file {i}'s base path is longer than its path")
        files.append((base + path[: base_len[i]].decode(), path[base_len[i]:].decode()))
        previous = path
    return files


def _refs(r: _Reader, files: list[tuple[str, str]], n: int, lengths: list[int] | None = None) -> list[Ref]:
    """``n`` references: a data file id column, an offset column and, unless
    ``lengths`` is given, a length column."""
    ids = r.column(n)
    offsets = r.column(n)
    lengths = r.column(n) if lengths is None else lengths
    for i in ids:
        if i >= len(files):
            raise ValueError(f"{r.what}: data file id {i} of a table of {len(files)}")
    return [Ref(*files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _keys(r: _Reader, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    """A node's ``n`` keys (each the part after the node's implied prefix) and,
    for an interior node, each entry's subtree common prefix length."""
    prefix = [0, *r.column(n - 1)]
    suffix = r.column(n)
    common = r.column(n) if interior else []
    keys, previous = [], b""
    for i in range(n):
        if prefix[i] > len(previous):
            raise ValueError(f"{r.what}: key {i} shares {prefix[i]} bytes of a {len(previous)}-byte key")
        previous = previous[: prefix[i]] + r.take(suffix[i])
        keys.append(previous)
    for key, c in zip(keys, common):
        if c > len(key):
            raise ValueError(f"{r.what}: a subtree prefix of {c} bytes on a {len(key)}-byte key")
    return keys, common


class OcdbtStore:
    """The newest version of the OCDBT store in ``directory``: ``list()`` and ``read(key)``."""

    def __init__(self, directory: str):
        self.directory = directory
        self._values: dict[bytes, bytes | Ref] = {}
        body = _Reader(unframe(self._file("manifest.ocdbt"), MANIFEST_MAGIC, self._where("manifest.ocdbt")),
                       self._where("manifest.ocdbt"))
        self._config(body)
        files = _data_file_table(body, "")
        n = body.varint()
        if n == 0:
            return  # a store with no commit yet
        generation = body.column(n)
        height = [body.byte() for _ in range(n)]
        roots = _refs(body, files, n)
        num_keys = body.column(n)
        body.column(n)  # the roots' tree bytes
        body.column(n)  # the roots' indirect value bytes
        body.take(8 * n)  # the commit times
        newest = max(range(n), key=generation.__getitem__)
        if num_keys[newest]:
            self._walk(roots[newest], height[newest], b"")

    def _where(self, relative: str) -> str:
        return os.path.join(self.directory, relative)

    def _file(self, relative: str, offset: int = 0, length: int | None = None) -> bytes:
        with open(self._where(relative), "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f"{self._where(relative)}: {len(data)} bytes at {offset}, not {length}")
        return data

    def _config(self, r: _Reader) -> None:
        r.take(16)  # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{r.what}: manifest kind {kind}; only 0 (single, as Orbax writes) is read")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        compression = r.varint()
        if compression == 1:
            r.take(4)  # the zstd level, an int32 little-endian
        elif compression != 0:
            raise ValueError(f"{r.what}: configured compression {compression} is neither 0 nor 1")

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        where = f"{self._where(ref.base + ref.relative)} @ {ref.offset}"
        r = _Reader(unframe(self._file(ref.base + ref.relative, ref.offset, ref.length), NODE_MAGIC, where), where)
        got = r.byte()
        if got != height:
            raise ValueError(f"{where}: a node of height {got} where {height} was expected")
        files = _data_file_table(r, ref.base)
        n = r.varint()
        if n == 0:
            raise ValueError(f"{where}: an empty b-tree node")
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            children = _refs(r, files, n)
            for key, c, child in zip(keys, common, children):
                self._walk(child, height - 1, prefix + key[:c])
            return
        lengths = r.column(n)
        kinds = r.column(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{where}: a value kind other than 0 (inline) or 1 (reference)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        refs = dict(zip(indirect, _refs(r, files, len(indirect), [lengths[i] for i in indirect])))
        for i in range(n):
            self._values[prefix + keys[i]] = refs[i] if i in refs else r.take(lengths[i])
        if r.pos != len(r.data):
            raise ValueError(f"{where}: {len(r.data) - r.pos} bytes left after the last value")

    def list(self) -> list[bytes]:
        """Every key, sorted."""
        return sorted(self._values)

    def read(self, key: bytes) -> bytes | None:
        """The value under ``key``, or None where there is none."""
        value = self._values.get(key)
        if isinstance(value, Ref):
            return self._file(value.base + value.relative, value.offset, value.length)
        return value
