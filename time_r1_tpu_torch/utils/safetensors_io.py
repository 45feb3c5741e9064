"""The safetensors file format, read and written by the port itself.

HF checkpoints (`models/qwen25vl/convert.py`) and the port's own native
checkpoints (`utils/checkpoint.py`) are safetensors files. The machines the
port runs on need not have the `safetensors` package, so this module reads
and writes the format directly:

- 8 bytes, little-endian: N, the length of the JSON header;
- N bytes of JSON: {name: {"dtype", "shape", "data_offsets": [begin, end]},
  "__metadata__": {str: str}}, the offsets relative to the end of the header;
  the writer pads the header with spaces to a multiple of 8 bytes;
- the tensors' bytes, row-major, little-endian, one after the other.

Reads go through a copy-on-write `mmap` and `torch.frombuffer`: a tensor is a
view of the mapped file until its caller moves it, so a 7.5 GB checkpoint is
not copied twice on its way to the card. bf16 goes through torch (numpy has
no bf16). Writes stream one tensor at a time (a tensor on the card is copied
to the host alone) into a temporary file that `os.replace` then renames: a
reader never sees half a file.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Mapping, Optional

import torch

DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}
CODES = {v: k for k, v in DTYPES.items()}


def read_header(path: str) -> tuple[dict, int]:
    """(the JSON header, the file offset where the tensors' bytes begin)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one file, as CPU tensors over a copy-on-write mapping
    of it (writing to one never reaches the file)."""
    header, start = read_header(path)
    header.pop("__metadata__", None)
    out: dict[str, torch.Tensor] = {}
    if not header:
        return out
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which the reader does not take")
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * itemsize:
            raise ValueError(f"{path}: tensor {name} spans {end - begin} bytes, its shape {shape} needs "
                             f"{numel * itemsize}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (start + begin) % itemsize:  # misaligned for its dtype: read through a copy of its bytes
            raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=start + begin).clone()
            out[name] = raw.view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=numel, offset=start + begin).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor], metadata: Optional[dict] = None,
                      dtype: Optional[torch.dtype] = None) -> int:
    """Write `tensors` (any device, any of DTYPES; all cast to `dtype` as
    they are written, when it is given) to `path` atomically; returns the
    bytes written. `metadata` values must be strings."""
    entries, offset = {}, 0
    for name, t in tensors.items():
        out_dtype = dtype or t.dtype
        if out_dtype not in CODES:
            raise ValueError(f"tensor {name}: dtype {out_dtype} has no safetensors code here")
        nbytes = t.numel() * torch.empty((), dtype=out_dtype).element_size()
        entries[name] = {"dtype": CODES[out_dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header = {"__metadata__": {str(k): str(v) for k, v in (metadata or {}).items()}, **entries}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for t in tensors.values():
                if t.numel():
                    host = t.detach().to("cpu", dtype=dtype or t.dtype).contiguous().reshape(-1)
                    f.write(memoryview(host.view(torch.uint8).numpy()))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return 8 + len(raw) + offset
