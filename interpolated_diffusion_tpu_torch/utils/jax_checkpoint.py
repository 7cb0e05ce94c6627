"""Reader for the JAX package's checkpoints (its utils/checkpoint.py format).

A JAX checkpoint is a directory with `meta.json` ({step, meta, has_opt_state,
has_ema}, no "format" key) and flax `serialization.to_bytes` trees:
`params.msgpack`, and `ema.msgpack` / `opt_state.msgpack` when they were
saved. Those are msgpack maps whose array leaves are msgpack ext type 1 with
the payload msgpack((shape, dtype name, C-order bytes)); ext 2 is a Python
complex (real, imag) and ext 3 a numpy scalar (an ndarray payload of shape
()). Arrays larger than 2^30 bytes arrive as {"__msgpack_chunked_array__",
"shape", "chunks"} maps and are joined back.

The decoder here is plain Python (no `msgpack` package). Array leaves come
back as torch tensors on the CPU; bfloat16, which numpy lacks, is read as
uint16 bits viewed as torch.bfloat16. `load_jax_checkpoint` turns the params
and EMA trees into the port's state_dicts (models/jax_import
.checkpoint_to_state_dict); the optax optimizer state does not cross over.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import torch

PARAMS, EMA = "params.msgpack", "ema.msgpack"

_DTYPES = {
    "float16": torch.float16, "float32": torch.float32, "float64": torch.float64,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


class _Reader:
    """One pass over a msgpack buffer. `raw` keeps str objects as bytes (the
    array payloads are packed with use_bin_type and read raw by flax)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c])))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
            return self.ext(self.unpack(">b"), n)
        if c in (0xCA, 0xCB):
            return self.unpack(">f" if c == 0xCA else ">d")
        if 0xCC <= c <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[c - 0xCC])
        if 0xD4 <= c <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c]))
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x}")

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == 1:
            return _ndarray(payload)
        if code == 2:
            re, im = _Reader(payload).value()
            return complex(re, im)
        if code == 3:
            return _ndarray(payload)
        raise ValueError(f"msgpack: ext type {code} is not a flax type")


def _ndarray(payload: bytes) -> torch.Tensor:
    shape, dtype_name, buf = _Reader(payload, raw=True).value()
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name not in _DTYPES:
        raise ValueError(f"msgpack: array dtype {name!r} is not read here")
    dtype = _DTYPES[name]
    if dtype == torch.bfloat16:   # numpy has no bfloat16: the bits as uint16
        flat = torch.frombuffer(bytearray(buf), dtype=torch.uint16).view(torch.bfloat16)
    elif len(buf) == 0:
        flat = torch.empty(0, dtype=dtype)
    else:
        flat = torch.frombuffer(bytearray(buf), dtype=dtype)
    return flat.reshape([int(s) for s in shape])


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [int(tree["shape"][str(i)]) for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree that flax.serialization.msgpack_restore reads from `data`,
    with torch tensors (CPU) in place of numpy arrays."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)


def read_tree(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def is_jax_checkpoint(path: str) -> bool:
    """A checkpoint directory the JAX package wrote (params.msgpack)."""
    return os.path.exists(os.path.join(path, PARAMS))


def load_jax_checkpoint(path: str, map_location="cpu", with_opt_state: bool = True
                        ) -> Tuple[int, Dict[str, Any]]:
    """(step, payload) of a JAX checkpoint directory in the layout of the
    port's utils/checkpoint.load_checkpoint: `meta`, `params` and, when it was
    saved, `ema`, each the port's state_dict for the checkpoint's stage.

    The optax optimizer state is not read, so a caller that asks for it
    (`with_opt_state`, as the trainers' --resume does) gets
    NotImplementedError: a run cannot resume from a JAX checkpoint."""
    from ..models.jax_import import checkpoint_to_state_dict

    with open(os.path.join(path, "meta.json")) as f:
        header = json.load(f)
    if with_opt_state:
        raise NotImplementedError(
            f"{path} is a JAX checkpoint: its optax optimizer state (opt_state.msgpack) does "
            "not cross over to the port's optimizer, so training cannot resume from it; only "
            "params and EMA are read (load the weights through models/loading)")
    meta = header["meta"]

    def convert(name):
        sd = checkpoint_to_state_dict(meta, read_tree(os.path.join(path, name)))
        return _to(sd, map_location)

    payload: Dict[str, Any] = {"meta": meta, "params": convert(PARAMS)}
    if header.get("has_ema"):
        payload["ema"] = convert(EMA)
    return int(header["step"]), payload


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
