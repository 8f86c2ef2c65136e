"""zstd decoding through the system's ``libzstd``, bound with ``ctypes``.

The JAX package's Orbax checkpoints compress their OCDBT manifests and
b-tree nodes and their zarr chunks as zstd frames (``ckpt.ocdbt``,
``ckpt.orbax``). The port decodes them with the shared library that
``ctypes.util.find_library("zstd")`` finds (``libzstd.so.1`` on Debian and
Ubuntu), through zstd's streaming API, so a frame whose header carries no
content size decodes as well as one that does. The library is looked up
once, at the first decode, never when this module is imported. Where it is
missing or does not load, decoding raises and names it: there is no other
decoder.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The system's zstd library, loaded and declared at the first call; raises
    ``OSError`` naming what is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise OSError("no zstd library found (ctypes.util.find_library('zstd')): reading an "
                          "Orbax checkpoint needs the system's libzstd.so.1")
        lib = ctypes.CDLL(name)
        lib.ZSTD_versionNumber.restype = ctypes.c_uint
        lib.ZSTD_versionNumber.argtypes = []
        lib.ZSTD_createDCtx.restype = ctypes.c_void_p
        lib.ZSTD_createDCtx.argtypes = []
        lib.ZSTD_freeDCtx.restype = ctypes.c_size_t
        lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
        lib.ZSTD_DStreamOutSize.argtypes = []
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
                                              ctypes.POINTER(_InBuffer)]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        _lib = lib
        return lib


def describe() -> str:
    """Which library decodes, and its version, as ``name x.y.z``."""
    v = library().ZSTD_versionNumber()
    return f"{ctypes.util.find_library('zstd')} {v // 10000}.{v // 100 % 100}.{v % 100}"


def decompress(data: bytes, size: int | None = None) -> bytes:
    """The bytes that the zstd frames in ``data`` (one or more, back to back) decode to.

    ``size``, where the caller knows it, is the decoded length required.
    Raises ``ValueError`` on a corrupt or truncated frame, or on a length
    other than ``size``.
    """
    lib = library()
    data = bytes(data)
    src = ctypes.c_char_p(data)  # keeps ``data`` alive while libzstd reads it
    inbuf = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    cap = size if size else lib.ZSTD_DStreamOutSize()
    buf = ctypes.create_string_buffer(cap)
    out = bytearray()
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        while True:
            outbuf = _OutBuffer(ctypes.addressof(buf), cap, 0)
            ret = lib.ZSTD_decompressStream(dctx, ctypes.byref(outbuf), ctypes.byref(inbuf))
            if lib.ZSTD_isError(ret):
                raise ValueError(f"corrupt zstd frame: {lib.ZSTD_getErrorName(ret).decode()}")
            out += buf.raw[: outbuf.pos]
            if inbuf.pos == inbuf.size:
                if ret == 0:
                    break
                if outbuf.pos < cap:
                    raise ValueError(f"truncated zstd frame ({len(data)} bytes end inside it)")
    finally:
        lib.ZSTD_freeDCtx(dctx)
    if size is not None and len(out) != size:
        raise ValueError(f"zstd frame decodes to {len(out)} bytes, not the {size} expected")
    return bytes(out)
