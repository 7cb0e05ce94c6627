"""ctypes binding of the C++ maze generator (port of data/native.py).

The shard-generation hot loop (maze generation + A* + arclength resampling)
lives in `csrc/host/maze_gen.cpp`, the port's copy of the JAX package's
`native/maze_gen.cpp`. It is built on first use with

    g++ -O3 -shared -fPIC -o build/native/<hash of the source>/libmaze_native.so maze_gen.cpp

into the git-ignored `build/` tree at the root of the checkout (the flags of
the JAX package's own build, so that both libraries compute the same floats),
and a changed source builds anew. Nothing is built at import time. Its RNG
stream (std::mt19937_64, seeded per sample) differs from the numpy
generator's; both are deterministic.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "maze_gen.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libmaze_native.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def library_path(source: Optional[Path] = None, lib_name: str = LIB_NAME,
                 flags: Tuple[str, ...] = GXX_FLAGS) -> Path:
    """Where the library for the current source lives (built or not);
    `source` defaults to the module's SOURCE, read at call time."""
    source = SOURCE if source is None else source
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / lib_name


def build(source: Optional[Path] = None, lib_name: str = LIB_NAME,
          flags: Tuple[str, ...] = GXX_FLAGS) -> Path:
    """Compile `source` (csrc/host/maze_gen.cpp by default) with g++ unless
    the library for it exists; raises RuntimeError (with g++'s output) when
    the build fails."""
    source = SOURCE if source is None else source
    out = library_path(source, lib_name, flags)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{lib_name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {source.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def load_native() -> ctypes.CDLL:
    """The native library, built and loaded on first use (raises if it
    cannot be built)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.generate_maze_batch.restype = ctypes.c_int
        lib.generate_maze_batch.argtypes = [
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    try:
        load_native()
    except (RuntimeError, OSError):
        return False
    return True


def generate_maze_batch_native(
    seed: int, n: int, h: int, w: int, p_wall_min: float, p_wall_max: float,
    T: int, with_velocity: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x [n,T,D], occ [n,1,h,w], start_goal [n,4])."""
    lib = load_native()
    D = 4 if with_velocity else 2
    x = np.zeros((n, T, D), dtype=np.float32)
    occ = np.zeros((n, h, w), dtype=np.float32)
    sg = np.zeros((n, 4), dtype=np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    made = lib.generate_maze_batch(
        ctypes.c_uint64(seed), n, h, w,
        ctypes.c_float(p_wall_min), ctypes.c_float(p_wall_max),
        T, int(with_velocity),
        x.ctypes.data_as(fp), occ.ctypes.data_as(fp), sg.ctypes.data_as(fp),
    )
    if made != n:
        raise RuntimeError(f"native generator produced {made}/{n} samples")
    return x, occ[:, None], sg
