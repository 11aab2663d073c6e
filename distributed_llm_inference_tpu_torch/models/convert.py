"""Safetensors files as numpy arrays: the reader of the JAX package's
models/convert.py (`load_safetensors_file`, `_st_dtype`) and its writer.

The reader maps the file and returns zero-copy numpy views. BF16 has no
numpy dtype without `ml_dtypes`, which the card's machine lacks: a BF16
tensor's bits come back in a uint16 carrier whose dtype is marked `BF16`
(`is_bf16`), widened exactly to float32 by `as_float32`; where such bits
become a tensor they are viewed as torch.bfloat16.

The rest of the JAX module (HF state dicts to the port's params, and the
conversion CLI) is ROADMAP.md "Other families and loading".
"""

from __future__ import annotations

import json
import mmap

import numpy as np

# the BF16 carrier: uint16 bits, marked so that a genuine U16/I16 tensor
# is never taken for one
BF16 = np.dtype(np.uint16, metadata={"safetensors": "BF16"})

_ST_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def is_bf16(a: np.ndarray) -> bool:
    """True for an array in the BF16 carrier."""
    return (a.dtype.metadata or {}).get("safetensors") == "BF16"


def as_float32(a: np.ndarray) -> np.ndarray:
    """float32 values of an array: BF16 bits widened exactly (a bfloat16
    is the top half of a float32), anything else cast."""
    if is_bf16(a):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def to_bf16(a: np.ndarray) -> np.ndarray:
    """float values rounded to bfloat16 (to nearest even, as torch casts),
    in the BF16 carrier."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16).view(BF16)


def _st_dtype(name: str) -> np.dtype:
    if name == "BF16":
        return BF16
    try:
        return np.dtype(_ST_DTYPES[name])
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {name!r}") from None


def _st_name(a: np.ndarray) -> str:
    if is_bf16(a):
        return "BF16"
    for name, dt in _ST_DTYPES.items():
        if a.dtype == np.dtype(dt):
            return name
    raise ValueError(f"no safetensors dtype for {a.dtype}")


def load_safetensors_file(path: str) -> dict:
    """Read one .safetensors file into {name: np.ndarray} (zero-copy mmap
    views; the file mapping stays alive as long as the arrays do)."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    header_len = int.from_bytes(mm[:8], "little")
    header = json.loads(mm[8: 8 + header_len].decode("utf-8"))
    base = 8 + header_len
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = _st_dtype(meta["dtype"])
        shape = meta["shape"]
        o0, o1 = meta["data_offsets"]
        n = int(np.prod(shape)) if shape else 1
        if o1 - o0 != n * dt.itemsize:
            raise ValueError(
                f"{path}: tensor {name!r} length {o1 - o0} != "
                f"prod(shape)*itemsize {n * dt.itemsize}"
            )
        out[name] = np.frombuffer(mm, dtype=dt, count=n, offset=base + o0).reshape(shape)
    return out


def save_safetensors_file(path: str, tensors: dict) -> None:
    """Write {name: np.ndarray} as one .safetensors file (little-endian,
    names in sorted order, the header padded to 8 bytes). Arrays in the
    BF16 carrier are written as BF16."""
    header, blobs, off = {}, [], 0
    for name in sorted(tensors):
        a = tensors[name]
        data = np.ascontiguousarray(a).astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _st_name(a), "shape": list(a.shape),
                        "data_offsets": [off, off + len(data)]}
        blobs.append(data)
        off += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for data in blobs:
            f.write(data)
