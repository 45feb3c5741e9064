"""The port's native checkpoint format (`utils/checkpoint.py` over
`utils/safetensors_io.py`), on the CPU:

- a param tree in f32 and in bf16, and quantized trees (int8 and int4
  {q8|q4, s} dicts, decode-fused), round-trip bit for bit, through
  `load_params` and in place through `load_params_into`; `load_params`
  with a dtype casts all but the quantized dicts;
- the optimizer state (`rl/optim.py::OptState`: moments, the accumulation
  buffer, `count`, `mini_step`) round-trips;
- the file holds no pickle (a JSON header and raw bytes) and appears whole:
  a write that fails leaves the old file and no temporary one;
- a JAX package checkpoint (an orbax `params/` directory) is refused by name,
  and a tree of another shape is refused before anything is copied."""

import json
import os
import struct

import numpy as np
import pytest
import torch

import jax

from test_torch_bridge import jax_params, port_params
from time_r1_tpu_torch.ops.quant import quantize_params
from time_r1_tpu_torch.rl.optim import AdamWMultiSteps
from time_r1_tpu_torch.utils import checkpoint as ck
from time_r1_tpu_torch.utils.safetensors_io import read_header

torch.set_num_threads(2)


def _assert_same(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def _trees():
    f32 = port_params(jax_params(seed=1))
    bf16 = jax.tree.map(lambda t: t.to(torch.bfloat16), f32)
    return {"f32": f32, "bf16": bf16, "int8": quantize_params(bf16, bits=8),
            "int4": quantize_params(bf16, bits=4), "int8_unfused": quantize_params(f32, bits=8, fuse=False)}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4", "int8_unfused"])
def test_params_round_trip_bit_exact(tmp_path, kind):
    tree = _trees()[kind]
    nbytes = ck.save_params(str(tmp_path), tree)
    assert nbytes == os.path.getsize(ck.checkpoint_file(str(tmp_path)))
    assert ck.is_native_checkpoint(str(tmp_path))
    _assert_same(ck.load_params(str(tmp_path)), tree)
    like = jax.tree.map(torch.zeros_like, tree)
    ck.load_params_into(str(tmp_path), like)
    _assert_same(like, tree)


def test_load_params_casts_all_but_quantized_dicts(tmp_path):
    tree = _trees()["int8"]
    ck.save_params(str(tmp_path), tree)
    back = ck.load_params(str(tmp_path), dtype=torch.float32)
    layer = back["text"]["layers"][0]
    assert layer["qkv"]["q8"].dtype == torch.int8 and layer["qkv"]["s"].dtype == torch.float32
    assert torch.equal(layer["qkv"]["q8"], tree["text"]["layers"][0]["qkv"]["q8"])
    assert layer["input_layernorm"].dtype == torch.float32 and layer["qkv_b"].dtype == torch.float32
    assert back["visual"]["blocks"][0]["qkv_w"].dtype == torch.float32


def test_opt_state_round_trips(tmp_path):
    params = [torch.randn(5, 3, dtype=torch.bfloat16), torch.randn(7)]
    opt = AdamWMultiSteps(1e-2, every_k=2)
    state = opt.init(params)
    for _ in range(3):
        opt.update(params, [torch.randn_like(p) for p in params], state)
    assert state.count == 1 and state.mini_step == 1 and float(state.acc[0].float().abs().sum()) > 0
    ck.save_params(str(tmp_path), state.tree(), name="opt_state")
    fresh = opt.init(params)
    tree = fresh.tree()
    ck.load_params_into(str(tmp_path), tree, name="opt_state")
    fresh.load_tree(tree)
    assert (fresh.count, fresh.mini_step) == (state.count, state.mini_step)
    for a, b in zip(fresh.mu + fresh.nu + fresh.acc, state.mu + state.nu + state.acc):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_the_file_is_a_json_header_and_raw_bytes(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    ck.save_params(str(tmp_path), tree)
    path = ck.checkpoint_file(str(tmp_path))
    header, start = read_header(path)
    assert start % 8 == 0 and header["__metadata__"]["format"] == ck.FORMAT
    assert header["a"] == {"dtype": "I32", "shape": [2, 3], "data_offsets": [0, 24]}
    assert header["b.0"]["dtype"] == "BF16"
    raw = open(path, "rb").read()
    assert struct.unpack("<Q", raw[:8])[0] == start - 8
    assert np.frombuffer(raw[start:start + 24], np.int32).tolist() == list(range(6))
    json.loads(raw[8:start])  # no pickle anywhere: the header is all JSON


def test_a_failed_write_leaves_the_old_file(tmp_path, monkeypatch):
    from time_r1_tpu_torch.utils import safetensors_io

    ck.save_params(str(tmp_path), {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="complex"):  # refused before a byte is written
        ck.save_params(str(tmp_path), {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.complex64)})

    def no_rename(src, dst):
        raise OSError("the rename failed")

    monkeypatch.setattr(safetensors_io.os, "replace", no_rename)  # fails after the whole file is written
    with pytest.raises(OSError, match="rename"):
        ck.save_params(str(tmp_path), {"a": torch.zeros(3)})
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["params.safetensors"]
    assert torch.equal(ck.load_params(str(tmp_path))["a"], torch.ones(3))


def test_orbax_directory_and_a_foreign_tree_are_refused(tmp_path):
    from time_r1_tpu.utils.checkpoint import save_params as jax_save_params

    jax_save_params(str(tmp_path / "jax"), jax_params())
    with pytest.raises(ValueError, match="orbax"):
        ck.load_params(str(tmp_path / "jax"))
    ck.save_params(str(tmp_path / "port"), {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="tree differs"):
        ck.load_params_into(str(tmp_path / "port"), {"b": torch.ones(3)})
    with pytest.raises(ValueError, match=r"\(3,\)"):
        ck.load_params_into(str(tmp_path / "port"), {"a": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        ck.load_params(str(tmp_path / "nothing"))
