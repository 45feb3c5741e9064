"""The port's 7B plan (`time_r1_tpu_torch/parallel/plan.py`) against the JAX
package's (`time_r1_tpu/parallel/plan.py`): the whole budget of the tiny
config on one device equals JAX's `plan_7b_train_step` (which lowers the
tiny step on the CPU); the 7B's per-device tally at 8 and 16 devices equals
the one from JAX's `spec_for_path` / `_divisible` / `_sharded_bytes` over
`jax.eval_shape` of its init and a stub mesh (the 7B is not lowered in JAX
here); each rank's share of the recipe batch's rows; and `do_compile`'s
refusals."""

import numpy as np
import pytest

from time_r1_tpu_torch.parallel import plan

BUDGET_KEYS = ("n_devices", "params_total_gb", "params_per_device_gb", "grads_per_device_gb",
               "opt_state_per_device_gb", "opt_state_location", "steady_state_per_device_gb", "comp_rows",
               "prompt_len")


def test_tiny_budget_equals_jax():
    from time_r1_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig
    from time_r1_tpu.parallel.plan import format_budget as jax_format
    from time_r1_tpu.parallel.plan import plan_7b_train_step as jax_plan
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    want = jax_plan(cfg=JaxConfig.tiny_test(), n_devices=1)
    got = plan.plan_7b_train_step(cfg=Qwen25VLConfig.tiny_test(), n_devices=1)
    assert {k: got[k] for k in BUDGET_KEYS} == {k: want[k] for k in BUDGET_KEYS}
    assert plan.format_budget(got).splitlines()[1:4] == jax_format(want).splitlines()[1:4]


class _StubMesh:
    def __init__(self, n: int):
        self.shape = {"data": n, "model": 1}


@pytest.mark.parametrize("n", [8, 16])
def test_7b_tally_equals_jax(n):
    import jax
    import jax.numpy as jnp

    from time_r1_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig
    from time_r1_tpu.models.qwen25vl import init_params as jax_init
    from time_r1_tpu.parallel.plan import _sharded_bytes
    from time_r1_tpu.parallel.sharding import _divisible, _path_str, spec_for_path

    mesh = _StubMesh(n)
    sds = jax.eval_shape(lambda k: jax_init(JaxConfig.qwen25vl_7b(), k, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    total = per_dev = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(sds)[0]:
        nbytes = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        total += nbytes
        per_dev += _sharded_bytes(nbytes, _divisible(leaf.shape, spec_for_path(_path_str(path)), mesh), mesh)
    got = plan.plan_7b_train_step(n_devices=n)
    assert got["params_total_gb"] == total / 2**30
    assert got["params_per_device_gb"] == got["grads_per_device_gb"] == per_dev / 2**30
    assert got["opt_state_per_device_gb"] == 2 * per_dev / 2**30
    assert got["steady_state_per_device_gb"] == 2 * per_dev / 2**30  # the state in pinned host memory
    assert (got["comp_rows"], got["prompt_len"]) == (8 * -(-n // 8), 224 + 1568)


@pytest.mark.parametrize("n,k", [(1, 8), (4, 2), (16, 1)])
def test_rank_rows_cover_the_batch(n, k):
    """Each rank holds R/n completion rows with their prompt, as JAX's
    P(data) over the rows gives them; together the ranks hold every row once."""
    groups = [{"prompt_ids": [p], "completions": [[p, c] for c in range(8)], "advantages": np.arange(8.0) + p}
              for p in range(max(1, -(-n // 8)))]
    held = []
    for r in range(n):
        mine = plan._rank_groups(groups, n, r)
        assert sum(len(g["completions"]) for g in mine) == k
        held += [c for g in mine for c in g["completions"]]
        assert all(len(g["advantages"]) == len(g["completions"]) for g in mine)
    assert held == [c for g in groups for c in g["completions"]]


def test_do_compile_needs_its_ranks_and_the_card():
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    with pytest.raises(ValueError, match="process group of 2 ranks"):
        plan.plan_7b_train_step(n_devices=2, cfg=Qwen25VLConfig.tiny_test(), do_compile=True)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            plan.plan_7b_train_step(n_devices=1, cfg=Qwen25VLConfig.tiny_test(), do_compile=True)
