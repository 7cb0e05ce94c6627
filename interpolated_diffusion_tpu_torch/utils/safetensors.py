"""A reader and a writer of the safetensors format, numpy and torch only.

A file is an 8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__": {...}}
and then the raw little-endian tensor bytes, offsets counted from the end of
the header. bfloat16, which numpy lacks, is read as int16 bits viewed as
torch.bfloat16. Diffusers' Wan2.1 checkpoints are bf16 shards of this format.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

_NUMPY = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
          "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_TORCH = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
          torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
          torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of one .safetensors file."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype, shape = info["dtype"], tuple(info["shape"])
        raw = body[begin:end]
        if dtype == "BF16":
            bits = np.frombuffer(raw, dtype="<i2").reshape(shape)
            out[name] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        elif dtype in _NUMPY:
            arr = np.frombuffer(raw, dtype=np.dtype(_NUMPY[dtype]).newbyteorder("<"))
            out[name] = torch.from_numpy(arr.reshape(shape).astype(_NUMPY[dtype]))
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, which is not read here")
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} (contiguous, any of the dtypes above) to `path`."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _TORCH:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not written here")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _TORCH[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)     # the body starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
