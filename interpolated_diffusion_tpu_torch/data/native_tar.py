"""ctypes binding of the native tar-shard reader (port of data/native_tar.py).

Python's tarfile walks headers and copies member payloads under the GIL,
which serialises the device prefetcher's worker threads (utils/prefetch.py).
The native reader (`csrc/host/tar_reader.cpp`, the port's copy of the JAX
package's native/tar_reader.cpp) indexes a shard's ustar headers once and
serves members with pread(); ctypes foreign calls release the GIL, so
prefetch workers stream shards concurrently. The npy decode stays in numpy
(header parse + a view into the read buffer).

It is built on first use with

    g++ -O3 -std=c++17 -shared -fPIC -o build/native/<hash>/libtar_native.so tar_reader.cpp

into the git-ignored `build/` tree, as data/native.py builds the maze
generator; nothing is built at import time. `iter_tar_samples_native(path)`
yields exactly what the tarfile loop of data/wan_synth.iter_tar_samples
yields (same grouping, same arrays). wan_synth dispatches as the JAX package
does: through this reader when it builds, else through tarfile;
IDT_NATIVE_TAR=0 forces tarfile. `build_error()` says why it did not build,
and `NATIVE_READS` counts the shards this reader has opened, so that a
caller can require the native path (chip_smoke.py does).
"""
from __future__ import annotations

import ctypes
import io
import os
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from .native import build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "tar_reader.cpp"
LIB_NAME = "libtar_native.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

NATIVE_READS = {"shards": 0}   # shards opened by iter_tar_samples_native
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def build_library():
    """Compile csrc/host/tar_reader.cpp unless its library exists; raises
    RuntimeError with g++'s output when it cannot."""
    return build(SOURCE, LIB_NAME, GXX_FLAGS)


def load_native() -> Optional[ctypes.CDLL]:
    """The reader, built and loaded on first use; None when IDT_NATIVE_TAR=0
    or when it does not build (`build_error()` says why)."""
    global _lib, _error
    if os.environ.get("IDT_NATIVE_TAR", "1") == "0":
        return None
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return None
    lib.tar_open.restype = ctypes.c_void_p
    lib.tar_open.argtypes = [ctypes.c_char_p]
    lib.tar_close.restype = None
    lib.tar_close.argtypes = [ctypes.c_void_p]
    lib.tar_count.restype = ctypes.c_int
    lib.tar_count.argtypes = [ctypes.c_void_p]
    lib.tar_name.restype = ctypes.c_char_p
    lib.tar_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tar_size.restype = ctypes.c_longlong
    lib.tar_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tar_read.restype = ctypes.c_longlong
    lib.tar_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
    _lib = lib
    return lib


def native_tar_available() -> bool:
    return load_native() is not None


def build_error() -> Optional[str]:
    """Why the reader did not build (None when it did, or was not tried)."""
    return _error


class _MVReader:
    """Minimal file-like over a memoryview: numpy's header parser reads only
    the (small) header bytes, leaving the payload uncopied."""

    def __init__(self, mv: memoryview):
        self._mv = mv
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = bytes(self._mv[self.pos:self.pos + n])
        self.pos += len(b)
        return b


def _decode_npy(buf: bytearray) -> np.ndarray:
    """Zero-copy npy decode: the header by numpy's own parser, the data as a
    frombuffer view into the read buffer (the bytearray keeps it alive)."""
    f = _MVReader(memoryview(buf))
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:  # another version: the copying path
        return np.load(io.BytesIO(bytes(buf)), allow_pickle=False)
    if fortran or dtype.hasobject:
        return np.load(io.BytesIO(bytes(buf)), allow_pickle=False)
    arr = np.frombuffer(buf, dtype=dtype, offset=f.pos,
                        count=int(np.prod(shape)) if shape else 1)
    return arr.reshape(shape)


def iter_tar_samples_native(path: str) -> Iterator[Dict[str, np.ndarray]]:
    """Native twin of wan_synth.iter_tar_samples: {field: array} per key."""
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native tar reader unavailable: {_error or 'IDT_NATIVE_TAR=0'}")
    h = lib.tar_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    NATIVE_READS["shards"] += 1
    try:
        n = lib.tar_count(h)
        current_key: Optional[str] = None
        sample: Dict[str, np.ndarray] = {}
        for i in range(n):
            raw = lib.tar_name(h, i)
            if raw is None:
                continue
            base = os.path.basename(raw.decode())
            parts = base.split(".")
            if len(parts) < 3 or parts[-1] != "npy":
                continue
            key = ".".join(parts[:-2])
            field = parts[-2]
            if current_key is not None and key != current_key:
                if sample:
                    yield {"__key__": current_key, **sample}
                sample = {}
            current_key = key
            size = lib.tar_size(h, i)
            buf = bytearray(size)
            got = lib.tar_read(h, i, (ctypes.c_char * size).from_buffer(buf), size)
            if got != size:
                raise IOError(f"short read of {base} in {path}")
            sample[field] = _decode_npy(buf)
        if current_key is not None and sample:
            yield {"__key__": current_key, **sample}
    finally:
        lib.tar_close(h)
