"""The 7B's deployment plan: the per-device memory budget of its GRPO train
step over an n-device data mesh (port of `time_r1_tpu/parallel/plan.py`).

The north star is GRPO post-training of Qwen2.5-VL-7B over a multi-device
slice. The budget is counted from the port's rule table
(`sharding.param_specs` over a mesh of {data: n, model: 1}, FSDP) over the
7B's tree built on the `meta` device, so no byte is allocated: parameters
and gradients in bf16, AdamW's mu and nu mirroring the parameters, in
pinned host memory under `offload_optimizer`. The batch has the posttrain
recipe's shape (`rl.build_grpo_split_batch`: one ~1.8k-token video prompt ×
G rollouts × ~200-token completions), its prompt groups scaled so that the
rollout rows cover the data axis.

JAX lowers and compiles the step ahead of time and reads XLA's memory
analysis. The port has no such compile: `do_compile=True` runs one sharded
`train_step` at that shape on the card, from random weights, and reports
`argument_gb` (the rank's parameter blocks, its device optimizer state and
its batch on entry) and `temp_gb` (the card's peak above them).

    from time_r1_tpu_torch.parallel.plan import plan_7b_train_step, format_budget
    print(format_budget(plan_7b_train_step(n_devices=8)))
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .mesh import DATA_AXIS, MODEL_AXIS
from .sharding import mesh_sizes


def _sharded_bytes(leaf_nbytes: int, spec, mesh) -> int:
    """Per-device bytes of a leaf whose dims are sharded over the axes of
    `spec` (a tuple of axis names and None, a `Spec`'s dims) on `mesh` (a
    DeviceMesh or a {"data": n, "model": m} dict)."""
    sizes = mesh_sizes(mesh)
    denom = 1
    for ax in spec:
        if ax is not None:
            denom *= sizes[ax]
    return -(-leaf_nbytes // denom)


def _recipe_groups(cfg, n_devices: int, prompt_text_tokens: int, video_grid, completion_len: int,
                   num_generations: int) -> list:
    """JAX's recipe-shaped prompt groups, drawn in its order from the same
    seed: P = ceil(n / G) prompts of G completions each."""
    t, h, w = video_grid
    n_patches = t * h * w
    n_vis = n_patches // 4
    rng = np.random.default_rng(0)
    groups = []
    for _ in range(max(1, -(-n_devices // num_generations))):
        prompt = (list(rng.integers(2, 100000, prompt_text_tokens - 2)) + [cfg.vision_start_token_id]
                  + [cfg.video_token_id] * n_vis + [cfg.vision_end_token_id])
        comps = [list(rng.integers(2, 100000, completion_len - 1)) + [cfg.eos_token_id]
                 for _ in range(num_generations)]
        groups.append({
            "prompt_ids": prompt,
            "completions": comps,
            "advantages": rng.normal(size=num_generations).astype(np.float32),
            "patches": rng.normal(size=(n_patches, cfg.vision.patch_input_dim)).astype(np.float32),
            "grid_thw": video_grid,
            "second_per_grid_t": 1.0,
        })
    return groups


def _rank_groups(groups: list, n: int, r: int) -> list:
    """Rank r's share of the rows (prompt-major, G a prompt), as JAX's P(data)
    over the completion rows gives it: rows [r·R/n, (r+1)·R/n), each with
    its prompt; the rows of a prompt split among ranks evenly."""
    G = len(groups[0]["completions"])
    rows = len(groups) * G
    if rows % n:
        raise ValueError(f"{rows} completion rows do not split over {n} data ranks")
    k = rows // n
    if not (G % k == 0 or k % G == 0):
        raise ValueError(f"{k} rows a rank split prompts of {G} rows unevenly")
    out = []
    for p in range(r * k // G, ((r + 1) * k - 1) // G + 1):
        lo, hi = max(r * k - p * G, 0), min((r + 1) * k - p * G, G)
        g = groups[p]
        out.append(dict(g, completions=g["completions"][lo:hi], advantages=g["advantages"][lo:hi]))
    return out


def plan_7b_train_step(
    n_devices: Optional[int] = None,
    prompt_text_tokens: int = 224,
    video_grid=(8, 28, 28),
    completion_len: int = 200,
    num_generations: int = 8,
    beta: float = 0.04,
    offload_optimizer: bool = True,
    do_compile: bool = False,
    cfg=None,
) -> dict:
    """The 7B GRPO train step's per-device budget over an n-device data mesh
    (n_devices None: the ranks of the process group, else the cards).

    Returns JAX's keys: n_devices, params_total_gb, params_per_device_gb,
    grads_per_device_gb, opt_state_per_device_gb, opt_state_location,
    steady_state_per_device_gb, comp_rows, prompt_len; with do_compile also
    `compiled`, `argument_gb` and `temp_gb` (`_run_step`)."""
    import torch

    from ..models.qwen25vl import Qwen25VLConfig, init_params
    from ..rl import build_grpo_split_batch
    from ..rl.grpo import _leaves
    from .sharding import param_specs

    if n_devices is None:
        import torch.distributed as dist

        n_devices = dist.get_world_size() if dist.is_initialized() else max(torch.cuda.device_count(), 1)
    cfg = cfg or Qwen25VLConfig.qwen25vl_7b()
    mesh = {DATA_AXIS: n_devices, MODEL_AXIS: 1}
    tree = init_params(cfg, device="meta", dtype=torch.bfloat16)  # shapes and dtypes, no bytes

    # ---- per-device budget (FSDP rule table over the data axis) ----
    p_total = p_dev = 0
    for leaf, spec in zip(_leaves(tree), _leaves(param_specs(tree, mesh))):
        nbytes = leaf.numel() * leaf.element_size()
        p_total += nbytes
        p_dev += _sharded_bytes(nbytes, spec.dims, mesh)
    # grads mirror the params (bf16); AdamW's mu and nu mirror the params
    budget = {
        "n_devices": n_devices,
        "params_total_gb": p_total / 2**30,
        "params_per_device_gb": p_dev / 2**30,
        "grads_per_device_gb": p_dev / 2**30,
        "opt_state_per_device_gb": 2 * p_dev / 2**30,
        "opt_state_location": "pinned_host" if offload_optimizer else "hbm",
    }
    hbm = budget["params_per_device_gb"] + budget["grads_per_device_gb"]
    if not offload_optimizer:
        hbm += budget["opt_state_per_device_gb"]
    budget["steady_state_per_device_gb"] = hbm

    # ---- the recipe-shaped batch (host arrays; tens of MB) ----
    groups = _recipe_groups(cfg, n_devices, prompt_text_tokens, video_grid, completion_len, num_generations)
    batch = build_grpo_split_batch(cfg, groups, dtype=torch.bfloat16, device="cpu")
    budget["comp_rows"] = batch.comp_ids.shape[0]
    budget["prompt_len"] = len(groups[-1]["prompt_ids"])
    if do_compile:
        budget.update(_run_step(cfg, groups, n_devices, beta, num_generations, offload_optimizer))
    return budget


def _run_step(cfg, groups: list, n: int, beta: float, num_generations: int, offload: bool) -> dict:
    """One train_step of the budget's configuration on this process's card
    (every rank of an n-rank group calls it together; n = 1 needs no
    group): random bf16 weights, this rank's blocks by the rule table, AdamW
    (clip 1.0, lr 1e-6) with the state offloaded as asked, the rank's rows
    of the recipe batch with zero reference log-probs, fix_vit and remat.
    argument_gb: the bytes on the card on entry; temp_gb: the peak above
    them."""
    import torch
    import torch.distributed as dist

    from ..models.qwen25vl import init_params
    from ..rl import build_grpo_split_batch
    from ..rl.grpo import GRPOHyperParams, make_train_step, trainable_leaves
    from ..rl.optim import AdamWMultiSteps
    from .mesh import data_group, make_mesh
    from .sharding import ShardContext

    if n > 1 and not (dist.is_initialized() and dist.get_world_size() == n):
        raise ValueError(f"do_compile over {n} devices runs in a process group of {n} ranks (torchrun)")
    if not torch.cuda.is_available():
        raise RuntimeError("do_compile runs the step on the card: CUDA is not available")
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank() if n > 1 else 0
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    shard = group = None
    numels = None
    if n > 1:
        mesh = make_mesh(1)
        shard, group = ShardContext.build(mesh, params), data_group(mesh)
        numels = [p.numel() for p in trainable_leaves(params, True)]
        params = shard.shard(params)
    batch = build_grpo_split_batch(cfg, _rank_groups(groups, n, rank), dtype=torch.bfloat16, device=dev)
    if beta != 0.0:
        batch = batch._replace(ref_logps=torch.zeros(batch.comp_ids.shape, dtype=torch.float32, device=dev))
    hp = GRPOHyperParams(num_generations=num_generations, beta=beta, use_grpo=False, fix_vit=True,
                         gradient_checkpointing=True)
    optimizer = AdamWMultiSteps(1e-6, max_grad_norm=1.0)
    opt_state = optimizer.init(trainable_leaves(params, True), offload=offload, numels=numels)
    step = make_train_step(cfg, hp, optimizer, group=group, shard=shard)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    entry = torch.cuda.memory_allocated(dev)
    _, opt_state, loss, _ = step(params, opt_state, batch)
    opt_state.wait()
    torch.cuda.synchronize(dev)
    out = {"compiled": True, "argument_gb": entry / 2**30,
           "temp_gb": (torch.cuda.max_memory_allocated(dev) - entry) / 2**30, "loss": float(loss)}
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return out


def format_budget(b: dict) -> str:
    lines = [
        f"7B GRPO train step over {b['n_devices']}-device data mesh "
        f"(prompt {b['prompt_len']} tokens, {b['comp_rows']} completion rows):",
        f"  params  {b['params_total_gb']:.2f} GB total → {b['params_per_device_gb']:.2f} GB/device (bf16, FSDP)",
        f"  grads   {b['grads_per_device_gb']:.2f} GB/device (bf16)",
        f"  adamw   {b['opt_state_per_device_gb']:.2f} GB/device ({b['opt_state_location']})",
        f"  steady-state device memory {b['steady_state_per_device_gb']:.2f} GB/device "
        f"(+ activations bounded by remat)",
    ]
    if "temp_gb" in b:
        lines.append(f"  one step on the card: arguments {b['argument_gb']:.2f} GB, peak above them "
                     f"{b['temp_gb']:.2f} GB")
    return "\n".join(lines)
