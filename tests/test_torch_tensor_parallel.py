"""Tensor parallelism over two gloo ranks (mesh data 1 × model 2): the cases
of tests/test_torch_fsdp.py (`run_mesh_cases`) on the other mesh shape.

Each rank holds its column and row blocks (the rank's q heads over its kv
heads, G unchanged; half the MLP width; the vision qkv split per head) and
both train on the same group:

- `decoder_forward`, the loss chunk of `shared_decode_forward` and the
  vision tower (K2/K3's plain versions on one head a rank, and the
  differentiable attention) equal one process's, 1e-5 relative (f32: the
  row-parallel products' partial sums are all-reduced);
- one `make_train_step(shard=...)` step, remat off and "full", fix_vit on
  and off, against JAX's `make_train_step` over `shard_params` on a 1×2
  mesh (optax, f32): loss 1e-4, metrics and grad_norm 2e-4, the gathered
  weights 2e-6 absolute (lr 1e-3, eps 1e-4); nothing summed over "model"
  for the norms, biases, embedding and head that every model rank holds
  whole (a doubled gradient would break the weights' tolerance);
- the gather counts and the arena's bytes as over FSDP (a model-1 data axis
  gathers nothing, so the counts are the layer calls).

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import pytest

from test_torch_fsdp import (
    STEPS,
    check_broadcast,
    check_forwards,
    check_gathers,
    check_offload,
    check_step,
    run_mesh_cases,
    spawn_mesh,
)


def _worker(rank: int, world: int, workdir: str) -> None:
    run_mesh_cases(rank, world, workdir, tp=2)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return spawn_mesh("test_torch_tensor_parallel", tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def refs():
    return {}


@pytest.mark.parametrize("name", ["decoder", "shared", "vision_kernel_False", "vision_kernel_True"])
def test_forwards_match_one_process(results, name):
    check_forwards(results, name)


@pytest.mark.parametrize("fix_vit,remat", STEPS, ids=[f"fix_vit_{f}-remat_{r}" for f, r in STEPS])
def test_step_matches_jax_on_a_mesh(results, refs, fix_vit, remat):
    check_step(results, 1, 2, fix_vit, remat, refs)


def test_remat_gathers_each_layer_twice_and_frees(results):
    check_gathers(results)


def test_offload_arena_holds_the_blocks(results):
    check_offload(results)


def test_broadcast_over_a_one_rank_data_group(results):
    check_broadcast(results)
