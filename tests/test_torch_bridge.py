"""The PyTorch port's parameter bridge and import hygiene.

Also the shared set-up of the port's tests: the tiny config of both packages
and the JAX init tree handed to the port through `params_from_jax`."""

import importlib
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from time_r1_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig
from time_r1_tpu.models.qwen25vl import init_params as jax_init_params
from time_r1_tpu_torch.models.qwen25vl import (
    Qwen25VLConfig,
    init_params,
    params_from_jax,
    params_to_jax,
)

torch.set_num_threads(2)

VOCAB = 256
JCFG = JaxConfig.tiny_test(VOCAB)
CFG = Qwen25VLConfig.tiny_test(VOCAB)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "time_r1_tpu_torch")


def jax_params(seed: int = 0, cfg=JCFG):
    return jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def port_params(params, cfg=CFG):
    """The JAX tree's weights as the port's f32 CPU params."""
    return params_from_jax(numpy_tree(params), cfg, device="cpu", dtype=torch.float32)


def test_params_roundtrip_bit_exact():
    tree = numpy_tree(jax_params())
    back = params_to_jax(params_from_jax(tree, CFG, device="cpu", dtype=torch.float32), CFG)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_params_from_jax_layout():
    """(in, out) JAX weights become torch's (out, in); stacked layers a list."""
    tree = numpy_tree(jax_params())
    p = params_from_jax(tree, CFG, device="cpu", dtype=torch.float32)
    assert len(p["text"]["layers"]) == CFG.text.num_hidden_layers
    assert len(p["visual"]["blocks"]) == CFG.vision.depth
    q_w = tree["text"]["layers"]["self_attn"]["q_w"][1]
    np.testing.assert_array_equal(p["text"]["layers"][1]["q_w"].numpy(), q_w.T)
    qkv = tree["visual"]["blocks"]["attn"]["qkv_w"][0]
    np.testing.assert_array_equal(p["visual"]["blocks"][0]["qkv_w"].numpy(), qkv.T)
    assert p["text"]["lm_head"].shape == (VOCAB, CFG.text.hidden_size)


def test_init_params_matches_jax_structure():
    """The port's own random init has the bridged tree's keys, shapes and
    init statistics (norms 1, biases 0, weights ~N(0, 0.02))."""
    mine = init_params(CFG, seed=3, device="cpu", dtype=torch.float32)
    bridged = port_params(jax_params())
    assert jax.tree.structure(mine) == jax.tree.structure(bridged)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(bridged)):
        assert a.shape == b.shape and a.dtype == b.dtype
    lp = mine["text"]["layers"][0]
    assert torch.all(lp["input_layernorm"] == 1) and torch.all(lp["q_b"] == 0)
    assert abs(mine["text"]["embed_tokens"].std().item() - 0.02) < 0.002
    again = init_params(CFG, seed=3, device="cpu", dtype=torch.float32)
    assert torch.equal(again["text"]["embed_tokens"], mine["text"]["embed_tokens"])


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from time_r1_tpu_torch.sampler import Engine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(CFG, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(port_params(jax_params()), CFG)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import time_r1_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'time_r1_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_port_sources_never_name_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages([PORT_DIR], "time_r1_tpu_torch.")]
    assert names
    for name in names:
        importlib.import_module(name)  # every module imports on a host without nvcc
    pattern = re.compile(r"\btime_r1_tpu\.|^\s*(import|from)\s+jax\b", re.M)
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, f)) as fh:
                    hit = pattern.search(fh.read())
                assert hit is None, (f, hit and hit.group(0))
