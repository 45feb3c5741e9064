"""The port's rule table (`time_r1_tpu_torch/parallel/sharding.py`) against
the JAX package's (`time_r1_tpu/parallel/sharding.py`):

- for every leaf of the port's tree, its spec equals the transpose of JAX's
  `param_shardings` over the same tree (the tiny config through
  `params_to_jax`; Qwen2.5-VL-3B and -7B with JAX's tree from
  `jax.eval_shape` and the port's on the `meta` device), on meshes (data,
  model) of 2×1, 1×2, 2×2, 4×1, 1×4 and 2×4 (JAX's over the 8 virtual CPU
  devices of tests/conftest.py): linear weights (out, in) here, (in, out)
  there, and no layer axis;
- the fused vision leaves (`qkv_w`, `qkv_b`) carry their per-head rule: rank
  m's block is its heads' q, then k, then v;
- on the tiny tree, shard then gather is bit-equal, and each leaf's blocks
  over every rank hold its bytes once per rank it is replicated over;
- at 3B and 7B, a rank's bytes equal JAX's `plan._sharded_bytes` reckoning
  summed over JAX's leaves (the same divisibility rule on both sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bridge import CFG, jax_params, port_params
from time_r1_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig
from time_r1_tpu.models.qwen25vl import init_params as jax_init_params
from time_r1_tpu.parallel import make_mesh as jax_make_mesh
from time_r1_tpu.parallel.plan import _sharded_bytes
from time_r1_tpu.parallel.sharding import param_shardings
from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params, params_to_jax
from time_r1_tpu_torch.models.qwen25vl.convert import _MERGER, _VISION_BLOCK, _text_layer_table
from time_r1_tpu_torch.parallel.sharding import Spec, _parts_major, mesh_sizes, param_specs, shard_leaf, shard_params

MESHES = [(2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (2, 4)]
D, M = "data", "model"


def unshard_blocks(blocks: dict, spec: Spec, sizes: dict) -> torch.Tensor:
    """A whole leaf from every rank's block ({(d, m): block}), offline: the
    inverse of `shard_leaf` that `gather_params` computes with collectives."""
    rows = []
    for d in range(sizes[D] if D in spec.dims else 1):
        cols = [blocks[(d, m)] for m in range(sizes[M] if M in spec.dims else 1)]
        rows.append(cols[0] if len(cols) == 1 else torch.cat(cols, dim=spec.dims.index(M)))
    x = rows[0] if len(rows) == 1 else torch.cat(rows, dim=spec.dims.index(D))
    if spec.parts > 1 and spec.dims and spec.dims[0] == M:
        x = _parts_major(x, spec.parts, sizes[M])
    return x


def leaf_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in _flat(tree))


def _jax_mesh(dp: int, tp: int):
    return jax_make_mesh(model_parallel=tp, devices=jax.devices()[: dp * tp])


def _jax_dims(jspecs, path: str, ndim: int) -> tuple:
    """JAX's spec for the port's leaf at `path`, in the port's layout: the
    layer axis dropped and an (in, out) kernel's two dims swapped."""
    parts = path.split("/")
    stacked, transposed = False, False
    if parts[0] == "text" and parts[1] == "layers":
        (jpath, _, transposed), = [t for t in _text_layer_table([parts[3]]) if t[1] == parts[3]]
        node, stacked = jspecs["text"]["layers"], True
    elif parts[0] == "visual" and parts[1] == "blocks":
        (jpath, _, transposed), = [t for t in _VISION_BLOCK if t[1] == parts[3]]
        node, stacked = jspecs["visual"]["blocks"], True
    elif parts[:2] == ["visual", "merger"]:
        (jpath, _, transposed), = [t for t in _MERGER if t[1] == parts[2]]
        node = jspecs["visual"]["merger"]
    else:
        jpath, transposed = {
            "visual/patch_embed": (("visual", "patch_embed", "kernel"), True),
            "text/embed_tokens": (("text", "embed_tokens", "embedding"), False),
            "text/lm_head": (("text", "lm_head", "kernel"), True),
            "text/norm": (("text", "norm", "scale"), False),
        }[path]
        node = jspecs
    for k in jpath:
        node = node[k]
    dims = tuple(node.spec) + (None,) * (ndim + stacked - len(tuple(node.spec)))
    dims = dims[1:] if stacked else dims
    return tuple(reversed(dims)) if transposed else dims


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _trees(name: str):
    """(the port's tree, JAX's tree or its shapes) for a config name."""
    if name == "tiny":
        port = port_params(jax_params())
        return port, params_to_jax(port, CFG)
    port_cfg = getattr(Qwen25VLConfig, name)()
    jcfg = getattr(JaxConfig, name)()
    jtree = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    return init_params(port_cfg, device="meta", dtype=torch.bfloat16), jtree


@pytest.fixture(scope="module", params=["tiny", "qwen25vl_3b", "qwen25vl_7b"])
def trees(request):
    return request.param, *_trees(request.param)


@pytest.mark.parametrize("dp,tp", MESHES, ids=[f"{d}x{t}" for d, t in MESHES])
def test_specs_are_jax_transposed(trees, dp, tp):
    name, port, jtree = trees
    jspecs = param_shardings(jtree, _jax_mesh(dp, tp))
    specs = dict(_flat(param_specs(port, {D: dp, M: tp})))
    leaves = dict(_flat(port))
    assert set(specs) == set(leaves)
    for path, spec in specs.items():
        assert spec.dims == _jax_dims(jspecs, path, leaves[path].ndim), path
        assert spec.parts == (3 if path.endswith(("qkv_w", "qkv_b")) else 1), path


@pytest.mark.parametrize("tp", [2, 4])
def test_fused_vision_leaves_split_per_head(tp):
    """Rank m's block of the (3·H·hd, H) qkv is [q of its heads; k of its
    heads; v of its heads], each a contiguous run of the part's rows."""
    w = torch.arange(3 * 8 * 6 * 5, dtype=torch.float32).reshape(3 * 8 * 6, 5)  # 8 heads of dim 6
    b = torch.arange(3 * 8 * 6, dtype=torch.float32)
    sizes = {D: 1, M: tp}
    for x in (w, b):
        spec = Spec((M,) + (None,) * (x.ndim - 1), parts=3)
        rows = 8 * 6 // tp
        blocks = {}
        for m in range(tp):
            blk = shard_leaf(x, spec, sizes, {D: 0, M: m})
            want = torch.cat([x[p * 48 + m * rows: p * 48 + (m + 1) * rows] for p in range(3)])
            assert torch.equal(blk, want)
            blocks[(0, m)] = blk
        assert torch.equal(unshard_blocks(blocks, spec, sizes), x)


@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1), (1, 2)], ids=["2x2", "4x1", "1x2"])
def test_shard_then_gather_is_bit_equal(dp, tp):
    port = port_params(jax_params())
    sizes = {D: dp, M: tp}
    specs = param_specs(port, sizes)
    blocks = {(d, m): dict(_flat(shard_params(port, sizes, {D: d, M: m}, specs))) for d in range(dp)
              for m in range(tp)}
    flat_specs = dict(_flat(specs))
    for path, leaf in _flat(port):
        spec = flat_specs[path]
        got = unshard_blocks({k: v[path] for k, v in blocks.items()}, spec, sizes)
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), path
        held = sum(v[path].numel() * v[path].element_size() for v in blocks.values())
        copies = (1 if D in spec.dims else dp) * (1 if M in spec.dims else tp)
        assert held == leaf.numel() * leaf.element_size() * copies, path
    assert sum(leaf_bytes(shard_params(port, sizes, {D: d, M: m}, specs)) for d in range(dp) for m in range(tp)) \
        >= leaf_bytes(port)


@pytest.mark.parametrize("name", ["qwen25vl_3b", "qwen25vl_7b"])
@pytest.mark.parametrize("dp,tp", [(4, 1), (2, 2), (1, 4)], ids=["4x1", "2x2", "1x4"])
def test_rank_bytes_match_jax_plan(name, dp, tp):
    port, jtree = _trees(name)
    mesh = _jax_mesh(dp, tp)
    jspecs = param_shardings(jtree, mesh)
    want = sum(_sharded_bytes(int(np.prod(x.shape)) * x.dtype.itemsize, s.spec, mesh)
               for x, s in zip(jax.tree.leaves(jtree), jax.tree.leaves(jspecs)))
    sizes = mesh_sizes({D: dp, M: tp})
    got = leaf_bytes(shard_params(port, sizes, {D: 0, M: 0}))
    assert got == want
    assert got < leaf_bytes(port)
