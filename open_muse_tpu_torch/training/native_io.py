"""ctypes bindings of the native multithreaded tar-shard reader.

The port's counterpart of ``open_muse_tpu/training/native_io.py``.  The
library's source is ``native/muse_io.cpp`` (C++ threads parse the tar
streams and group members into samples by key, into a bounded queue).  It
is compiled with the host C++ compiler (``$CXX``, else ``c++``) at first
use into the package's git-ignored ``_build/``, under a hash of the source
and flags, and never in ``native/``.  This is host I/O: no device kernel.
When the library cannot be built, ``Text2ImageDataset`` falls back to the
Python reader, as the JAX dataset does, and logs which reader ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional

__all__ = ["build_native", "native_available", "NativeShardReader", "SOURCE"]

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "muse_io.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")
_lock = threading.Lock()
_lib = None
_error: Optional[str] = None  # why the library is unavailable, once tried


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libmuse_io-{digest}.so"


def build_native() -> Optional[Path]:
    """The compiled library (built now if it is not there yet), or None when
    the source or the compiler is missing or the build fails (the reason in
    the log)."""
    global _error
    try:
        path = _library_path()
        if path.is_file():
            return path
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([os.environ.get("CXX", "c++"), *_FLAGS, "-o", tmp, str(SOURCE)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, path)  # atomic: concurrent builds each write their own file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path
    except (OSError, subprocess.CalledProcessError) as exc:
        _error = getattr(exc, "stderr", None) or str(exc)
        return None


def _load():
    """The loaded library, built and loaded once a process; None when that
    failed."""
    global _lib
    with _lock:
        if _lib is None and _error is None:
            path = build_native()
            if path is None:
                logger.warning("native shard reader unavailable: %s", _error)
                return None
            lib = ctypes.CDLL(str(path))
            lib.mio_pool_create.restype = ctypes.c_void_p
            lib.mio_pool_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int]
            lib.mio_pool_next.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.mio_pool_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
            lib.mio_pool_destroy.restype = None
            lib.mio_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.mio_free.restype = None
            lib.mio_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            _lib = lib
        return _lib


def native_available() -> bool:
    """True when the library is built and loaded (the reason it is not is
    logged once a process)."""
    return _load() is not None


class NativeShardReader:
    """Key-grouped samples of ``shard_urls`` read by ``num_threads`` C++
    threads, in the dict shape of ``data.tar_samples`` (``{'__key__': key,
    '<ext>': bytes, ...}``) but for ``__url__``; the order across shards
    follows the threads."""

    def __init__(self, shard_urls: List[str], num_threads: int = 4, queue_depth: int = 64):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native shard reader unavailable: {_error}")
        self._lib = lib
        self._urls = (ctypes.c_char_p * len(shard_urls))(*[u.encode() for u in shard_urls])
        self._pool = lib.mio_pool_create(self._urls, len(shard_urls), num_threads, queue_depth)
        self._closed = False

    def __iter__(self) -> Iterator[Dict[str, bytes]]:
        size = ctypes.c_int64()
        while True:
            ptr = self._lib.mio_pool_next(self._pool, ctypes.byref(size))
            if not ptr:
                return
            blob = ctypes.string_at(ptr, size.value)
            self._lib.mio_free(ptr)
            yield self._parse(blob)

    @staticmethod
    def _parse(blob: bytes) -> Dict[str, bytes]:
        """u32 n, then n times (u32 name length, name, u64 data length, data)."""
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        sample: Dict[str, bytes] = {}
        key: Optional[str] = None
        for _ in range(n):
            (name_len,) = struct.unpack_from("<I", blob, off)
            off += 4
            name = blob[off:off + name_len].decode()
            off += name_len
            (data_len,) = struct.unpack_from("<Q", blob, off)
            off += 8
            data = blob[off:off + data_len]
            off += data_len
            if name.startswith("./"):
                name = name[2:]
            if key is None:
                key = name.split(".", 1)[0]
            if "." in name:
                sample[name.split(".", 1)[1].lower()] = data
        sample["__key__"] = key
        return sample

    def close(self) -> None:
        if not self._closed:
            self._lib.mio_pool_destroy(self._pool)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
