"""The port's native checkpoints: a tree of tensors in one safetensors file.

The JAX package saves its trees with orbax (`time_r1_tpu/utils/checkpoint.py`),
which the card's machine does not have. The port writes `<path>/<name>.safetensors`
(`utils/safetensors_io.py`): every leaf under its path in the tree, dict keys
and list indices joined by dots ("text.layers.3.q_w"), in its own dtype, so
bf16 and f32 leaves and quantized {q8|q4, s} dicts come back bit for bit. No
pickle is read or written. The file appears whole or not at all: it is written
beside its place and renamed over it, as orbax renames its temporary
directory.

A directory that holds an orbax `params/` (a JAX package checkpoint) is
refused by name, never half-read.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .safetensors_io import read_header, read_safetensors, write_safetensors

FORMAT = "time_r1_tpu_torch"
_QUANT_KEYS = ("q8", "q4")


def checkpoint_file(path: str, name: str = "params") -> str:
    return os.path.join(path, f"{name}.safetensors")


def is_native_checkpoint(path: str, name: str = "params") -> bool:
    """Whether `path` holds a tree that save_params wrote under `name`."""
    f = checkpoint_file(path, name)
    return os.path.isfile(f) and read_header(f)[0].get("__metadata__", {}).get("format") == FORMAT


def refuse_orbax(path: str, name: str = "params") -> None:
    """Raise if `path/name` is an orbax directory: the JAX package's format."""
    if os.path.isdir(os.path.join(path, name)) and not is_native_checkpoint(path, name):
        raise ValueError(
            f"{os.path.join(path, name)} is an orbax directory, the JAX package's checkpoint format; the "
            f"PyTorch port reads its own ({name}.safetensors) or an HF checkpoint (config.json + "
            "*.safetensors): export the JAX checkpoint with its save_hf_checkpoint")


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "." in str(k) or str(k).isdigit():
                raise ValueError(f"checkpoint tree key {k!r}: keys may not hold dots or be all digits")
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree
    else:
        raise TypeError(f"checkpoint leaf {prefix[:-1]}: {type(tree).__name__} is not a tensor")


def flatten(tree) -> dict[str, torch.Tensor]:
    """{dotted path: leaf} in the tree's order."""
    out: dict[str, torch.Tensor] = {}
    _flatten(tree, "", out)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *parents, last = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def save_params(path: str, params, name: str = "params") -> int:
    """Write a tree of tensors (dicts and lists; any device) to
    `path/<name>.safetensors`; returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    return write_safetensors(checkpoint_file(path, name), flatten(params), {"format": FORMAT, "tree": name})


def _read(path: str, name: str) -> dict[str, torch.Tensor]:
    refuse_orbax(path, name)
    f = checkpoint_file(path, name)
    if not is_native_checkpoint(path, name):
        raise FileNotFoundError(f"{f}: no tree saved by save_params")
    return read_safetensors(f)


def _in_quantized(key: str, flat: dict) -> bool:
    parent = key.rsplit(".", 1)[0] + "."
    return any(f"{parent}{q}" in flat for q in _QUANT_KEYS)


def load_params(path: str, name: str = "params", device="cpu", dtype: Optional[torch.dtype] = None):
    """The tree save_params wrote, on `device`. With `dtype`, every leaf but
    those of quantized {q8|q4, s} dicts is cast to it."""
    flat = _read(path, name)
    out = {}
    for key, t in flat.items():
        cast = dtype if dtype is not None and not _in_quantized(key, flat) else t.dtype
        out[key] = t.to(device=device, dtype=cast, copy=True)
    return _unflatten(out)


@torch.no_grad()
def load_params_into(path: str, like, name: str = "params", block=None) -> None:
    """Copy the tree save_params wrote into the tensors of `like`, in place
    (one leaf at a time from the mapped file; whatever holds them sees the
    restored values). Its paths, shapes and dtypes must be like's. block:
    `(key, saved leaf) -> this rank's block of it` when `like` holds a
    sharded tree's blocks (`parallel/sharding.py`)."""
    flat = _read(path, name)
    want = flatten(like)
    if set(flat) != set(want):
        missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
        raise ValueError(f"{checkpoint_file(path, name)}: tree differs (missing {missing[:5]}, extra {extra[:5]})")
    for key, dst in want.items():
        src = flat[key] if block is None else block(key, flat[key])
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"{key}: saved {tuple(src.shape)} {src.dtype}, held {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src)
