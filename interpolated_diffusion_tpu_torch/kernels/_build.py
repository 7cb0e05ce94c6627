"""Build the port's CUDA kernels with nvcc and load them through ctypes.

All of `csrc/*.cu` is compiled into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds): one nvcc per
source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas=-v -c csrc/<name>.cu -o <name>.o        (each source, in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libid_kernels.so *.o

The library goes to `build/kernels/<hash of sources and flags>/` at the root
of the checkout, so a changed source rebuilds and an unchanged one loads the
existing library. Nothing here runs at import time.

`ID_KERNELS_NVCC_FLAGS` (environment, read at build time) appends flags to
every compile, for an A/B measurement of a compile-time switch of a source
(`-DID_GEMM_STREAM_ONLY`, csrc/fused_block.cu); they are part of the hash, so
each setting has a library of its own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libid_kernels.so"

_lib: Optional[ctypes.CDLL] = None
_functions: dict = {}
build_log = ""          # nvcc's output of the last build in this process
build_seconds = 0.0     # wall time of that build (0.0 if none ran)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags() -> tuple:
    return (*NVCC_FLAGS, *os.environ.get("ID_KERNELS_NVCC_FLAGS", "").split())


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(_flags()).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    global build_log, build_seconds
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.with_name(f"{src.stem}.{tag}.o")
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *_flags(), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *[str(o) for o in objs]], capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The library's C entry `name` with its argument types declared.

    Every entry returns a cudaError_t as int; pointers and the stream are
    passed as c_void_p so that ctypes does not cut them to 32 bits.
    """
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = load().id_error_string
        msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err} ({msg(err).decode()}) at launch")
