"""GRPO trainer (port of `time_r1_tpu/rl/trainer.py`), on one device or on
the ranks of a process group.

One `step_batch` is the job the system exists for: G-way rollouts with the
live policy weights (`Engine.generate`, num_return_sequences = G), host
rewards and group advantages, the loss batch (the split batch, or full rows
with `shared_prefix_loss=False`), the frozen ViT's hidden states taken from
the rollout's prefill (fix_vit), the reference log-probs, then forward,
backward and the optimizer micro-step (clip + AdamW inside MultiSteps,
`rl/optim.py`).

`offload_optimizer` keeps the optimizer state's moments and accumulation in
page-locked host memory between steps (one arena per tree) and streams them
through the card a leaf at a time in the update, bit-equal to the
device-resident state, for full-parameter and LoRA training alike: what lets
the 7B train all its parameters on one 80 GB card. A failure to place the
state raises (the JAX trainer falls back to a device-resident state;
ROADMAP §C).

Quantized rollouts (`rollout_quantization="int8" | "int4"`) follow the JAX
trainer's full-parameter branch: the engine keeps an int8/int4 copy of the
policy with an int8 KV cache, re-quantized from the live bf16 weights once
per `step_batch` (the weight_sync phase); the loss and the reference forward
stay bf16 over the unquantized tree. A quantized base is trainable only
through LoRA, as in JAX (ValueError).

LoRA (`use_peft`): the base is frozen and an adapter tree (`rl/lora.py`,
seeded by `seed`) is trained, merged inside each decoder layer of the loss;
with beta != 0 the unmerged base is the reference (`ref_params is params`).
The base may be bf16 or int8 (`ops/quant.py::quantize_params`, fused or
not; an int4 base has nothing to adapt: ValueError). The weight sync of each
`step_batch` takes one of three routes: over an int8 base the engine shares
the trainer's tree and gets the adapters as side products
(`Engine.set_lora_side`, no merge and no copy); over a bf16 base with
rollout_quantization the engine's int8 copy is made by merging and quantizing
one layer at a time (`rl/lora.py::merge_quantize`); over a bf16 base without
it the engine gets the merged tree. A LoRA checkpoint holds the merged model
(over an int8 base: the base itself) and the adapters beside it in the JAX
package's `lora_adapters.npz`. Over an int8 base the ViT must stay frozen
(fix_vit): its adapters could not ride the side path, so the port refuses
the combination when the trainer is built (the JAX package fails at its
first step; ROADMAP §C).

The host input path (`prepare_requests`) turns dataset examples into engine
Requests: the injected `video_loader` decodes and resizes the video (or an
offline-preprocessed `video.npz` is read), the processor renders the chat
template, tokenizes and patchifies, and the patches are staged on the
trainer's device in its dtype. It writes no trainer state, so `train()`'s
prefetch thread runs it one batch ahead.

`train()` is the epoch loop around `step_batch`: the linear warmup-and-decay
lr schedule (or a constant lr), the one-batch-ahead prefetch, logging to
the metric sinks (`report_to`: tensorboard, wandb), the save cadence in
optimizer steps and `max_steps`. Checkpoints (`save_checkpoint`,
`load_checkpoint_state`) are the port's own format (`utils/checkpoint.py`),
with the processor's tokenizer files beside the weights.
On resume the restored optimizer state survives `train()`: the moments,
Adam's count and the accumulation carry on, and only the schedule starts
over (JAX's `train()` re-initializes the state it restored; ROADMAP §C).
`gradient_checkpointing` selects the remat policy of the loss's decoder
layers (`remat_policy`).

Across processes (`mesh`, a `parallel.make_mesh` DeviceMesh (data, model);
torchrun launches one process a rank):
- sharding: a full-parameter trainer keeps the policy, the reference, the
  gradients and the optimizer state sharded by the rule table
  (`parallel/sharding.py`): FSDP over "data" (ZeRO-3: a layer's weights
  gathered just before use, gradients reduce-scattered; offload_optimizer
  pins the rank's blocks only) and Megatron-style TP over "model" (heads and
  MLP width split). Once a `step_batch`, in weight_sync, every rank gathers
  the policy and the rank that rolls out keeps it as the engine's own tree
  (quantized one layer at a time under rollout_quantization), as ZeRO-3
  gathers before `generate`: the engine and its captured decode run as on
  one card (ROADMAP §C). Model-rank 0 of each model group rolls out and
  scores, and broadcasts the groups, rewards and their metrics over the
  model group: all its ranks train on the same rows. The dataset shard, the
  loss normalizer, the metric gather and the gradient sums go by the data
  coordinate and the data group; a save gathers to global rank 0 (the
  optimizer state too) and a resume loads and shards. Where tp is a
  multiple of the kv heads each kv head is replicated on tp/nkv model ranks
  (`parallel/tensor.py`): their gradients are summed over the replicas
  after the backward and the replicas stay bit-equal. Refused by name
  (ROADMAP A13): a tp that does not divide the q or vision heads
  (`check_heads`), and a quantized base with model > 1.
- LoRA over a mesh: with model > 1 the frozen base (and the reference, which
  is that base) is sharded as a full-parameter trainer's is, and the adapters
  and their optimizer state stay whole on every rank (ROADMAP §C): each
  layer merges the part of them its blocks need, and the gradients are
  summed over the data group, and over the model group where the base leaf
  is cut over it (`rl/grpo.py::lora_value_and_grad`). The rolling-out rank
  gathers the base and merges the adapters one layer at a time (merged and
  quantized under rollout_quantization); `gathered_params` and a save give
  the merged policy, and the adapters once. With model 1 the base and the
  adapters stay whole on every rank and the adapters' gradients are summed
  over the data group.
- a sharded step where some data ranks' batches have video and others'
  none: such a rank runs the vision tower on a placeholder video whose
  features enter nothing (`rl/grpo.py::align_vision`), so the tower's
  collectives fire on every rank; JAX unions the videos instead.
- data parallelism: each rank trains its own shard of the dataset (padded to
  a common length by modular repetition, so that no rank's shard runs out
  first and hangs the others' collectives), rolls out its own examples with
  the trainer's seed, and takes the loss over its own rows with the global
  normalizer; the gradients are summed over the ranks before the clip
  (`rl/grpo.py::grpo_value_and_grad`). JAX's `_global_vision` /
  `_any_process_has_vision` exist because GSPMD assembles one global batch; a
  rank that runs its own forward and sums gradients needs no union of videos,
  and its loss, metrics and update equal the one-process step over the
  concatenated groups (tests/test_torch_multiprocess_dp.py).
- context parallelism (`context_parallel_size` = the mesh's data size, as in
  JAX; full rows padded to the layout's multiple, `shared_prefix_loss` off):
  the group trains one batch. Its first rank rolls out and scores and
  broadcasts the groups; every rank builds the same batch, the reference
  log-probs come from the ring forward of the whole group, and each rank's
  loss covers its own positions. With model > 1 the ring runs over the data
  group of the rank's model coordinate, on the rank's heads, and the groups
  go from global rank 0 to every rank of the mesh. Under LoRA every adapter
  merges into the base before the loss, as in JAX.
- without a mesh a trainer is a one-process trainer, whatever group its
  process is in.
- pop_metrics gathers the registry's keys with a presence mask (JAX's
  `_gather_metrics`); only global rank 0 writes checkpoints, metric sinks and
  trainer_state.json, with a barrier after each save; a resume reads the same
  directory on every rank. The frozen ViT is never captured from the rollout
  under a mesh, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.qwen25vl import Qwen25VLConfig
from ..models.qwen25vl.convert import (
    LORA_FILE,
    NATIVE_CONFIG,
    config_to_plain_dict,
    load_lora_npz,
    lora_from_jax,
    save_lora_npz,
)
from ..models.qwen25vl.model import vision_signature
from ..ops.quant import QBITS, is_quantized, quantize_layer, quantize_text_params
from ..parallel.comm import all_gather_vector
from ..parallel.mesh import MODEL_AXIS, data_group, kv_replica_group, mesh_coordinate, mesh_size, model_group
from ..parallel.ring_attention import ContextParallel
from ..parallel.sharding import ShardContext, gather_params, shard_leaf
from ..parallel.tensor import check_heads
from ..sampler import Engine, Request, SamplingParams
from ..utils.checkpoint import is_native_checkpoint, load_params_into, save_params
from ..utils.logging_sinks import DebugRewardLog
from ..utils.profiling import PhaseTimers
from .grpo import (
    GRPOHyperParams,
    align_vision,
    compute_group_advantages,
    compute_ref_logps,
    make_lora_train_step,
    make_train_step,
    precompute_frozen_vision,
    trainable_leaves,
)
from .lora import (
    LoRAConfig,
    apply_layer_lora,
    fused_splits_for,
    init_lora,
    lora_layers_tree,
    lora_leaves,
    merge_lora,
    merge_quantize,
)
from .optim import AdamWMultiSteps, join_schedules, linear_schedule
from .rollout import build_grpo_batch_groups, build_grpo_split_batch

SYSTEM_PROMPT = "You are a video analysis expert."

# Prompt templates v1/v2/v3 (timer1_trainer.py:63-67, timer1_trainer_ft.py:61-85)
QUESTION_TEMPLATE_TG_V1 = """To accurately pinpoint the event "[EVENT]" in the video, determine the precise time period of the event.

Output your thought process within the <think> </think> tags, including analysis with either specific time ranges (xx.xx to xx.xx) in <timestep> </timestep> tags.

Then, provide the start and end times (in seconds, precise to two decimal places) in the format "start time to end time" within the <answer> </answer> tags. For example: "12.54 to 17.83"."""

QUESTION_TEMPLATE_TG_V2 = """To accurately pinpoint the event "[EVENT]" in the video, determine the precise time period of the event.

Provide the start and end times (in seconds, precise to two decimal places) in the format "start time to end time" within the <answer> </answer> tags. For example: "12.54 to 17.83"."""

QUESTION_TEMPLATE_TG_V3 = """Carefully analyze the video content to determine the precise time period during which "[EVENT]" occurs.  Within the `<think>` tags, provide a detailed description of your thought process, following the format below:
```
<think>
Step-by-step Analysis:
<timestep>Time period 1 (start time to end time)</timestep>: Describe the video content within this time period and determine if it is related to "[EVENT]".
<timestep>Time period 2 (start time to end time)</timestep>: Describe the video content within this time period and determine if it is related to "[EVENT]".
Based on the above analysis, state the precise time period during which "[EVENT]" occurs.
</think>
```
Finally, in the `<answer>` tags, provide the start and end times of "[EVENT]" in the format "start time to end time" (in seconds, precise to two decimal places). For example: "12.54 to 17.83".
```
<answer>
start time to end time
</answer>
```"""

PROMPT_TEMPLATES = {
    "v1": QUESTION_TEMPLATE_TG_V1,
    "v2": QUESTION_TEMPLATE_TG_V2,
    "v3": QUESTION_TEMPLATE_TG_V3,
}


class _MultiSink:
    """Fan metric logs out to every configured sink (tensorboard, wandb)."""

    def __init__(self, sinks):
        self.sinks = sinks

    def log(self, metrics, step):
        for s in self.sinks:
            s.log(metrics, step)

    def close(self):
        for s in self.sinks:
            s.close()


@dataclass
class TrainConfig:
    """The JAX package's TrainConfig: the reference recipes' flag names and defaults."""

    output_dir: str = "./logs/run"
    learning_rate: float = 1e-6
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.0
    num_train_epochs: float = 5
    gradient_accumulation_steps: int = 2
    per_device_train_batch_size: int = 1
    max_prompt_length: int = 8192
    max_completion_length: int = 200
    num_generations: int = 8
    temperature: float = 1.0
    beta: float = 0.04
    use_grpo: bool = False
    fix_vit: bool = True
    gradient_checkpointing: bool = False
    remat_policy: str = "full"
    use_peft: bool = False
    lora_r: int = 16
    lora_alpha: float = 32.0
    rollout_quantization: str = ""
    shared_prefix_loss: bool = True
    context_parallel_size: int = 1
    context_parallel_layout: str = "zigzag"
    prompt_type: str = "v1"
    total_pixels: int = 3584 * 28 * 28
    min_pixels: int = 16 * 28 * 28
    logging_steps: int = 1
    save_steps: int = 50
    save_strategy: str = "steps"
    save_only_model: bool = True
    seed: int = 42
    lr_scheduler_type: str = "linear"
    is_early_stopping: bool = False
    resume_from_checkpoint: Optional[str] = None
    report_to: str = "tensorboard"
    run_name: str = ""
    logging_dir: Optional[str] = None
    offload_optimizer: bool = False


def make_conversation_video(example: dict, prompt_type: str, total_pixels: int, min_pixels: int):
    """The upstream conversation (timer1_trainer.py:490-510,
    timer1_trainer_ft.py:511-535) with prompt template v1/v2/v3."""
    prompt_text = PROMPT_TEMPLATES[prompt_type].replace("[EVENT]", example["problem"])
    return [
        {
            "role": "user",
            "content": [
                {"type": "text", "text": prompt_text},
                {
                    "type": "video",
                    "video": example["video_path"],
                    "video_start": example.get("video_start"),
                    "video_end": example.get("video_end"),
                    "total_pixels": total_pixels,
                    "min_pixels": min_pixels,
                },
            ],
        }
    ]


class GRPOTrainer:
    """GRPO trainer. `processor` is a `Qwen25VLProcessor` (or
    anything with its `apply_chat_template`, `__call__` and `batch_decode`);
    `video_loader(ele: dict) -> (frames TCHW float, sample_fps)` decodes an
    example's video (`video.pipeline.video_loader`, or a fake in tests).
    `step_batch` takes the examples' engine Requests, or builds them with
    `prepare_requests` when given none.

    Full-parameter training updates `params` in place; the engine holds the
    same tensors, so the rollouts sample from the live weights with no copy
    (with rollout_quantization it holds a quantized copy, re-made at each
    weight sync).
    With beta ≠ 0, `ref_params` (a separate copy) gives the KL reference, as in
    the JAX trainer, which likewise has no reference without one; under LoRA
    the frozen base is the reference.
    With use_peft, `lora` holds the adapters the optimizer updates in place
    and `params` stays as it was given."""

    def __init__(
        self,
        params: dict,
        cfg: Qwen25VLConfig,
        processor,
        reward_funcs: Sequence[Callable],
        metric_funcs: Sequence[Callable] = (),
        config: Optional[TrainConfig] = None,
        video_loader: Optional[Callable] = None,
        ref_params: Optional[dict] = None,
        dtype=torch.bfloat16,
        mesh=None,
        device="cuda",
    ):
        config = dataclasses.replace(config) if config is not None else TrainConfig()
        lp = params["text"]["layers"][0]
        self._fused_base = "qkv" in lp
        self._quantized_base = is_quantized(lp["qkv"] if self._fused_base else lp["q_w"])
        if self._quantized_base and not config.use_peft:
            raise ValueError(
                "a quantized base is trainable via LoRA only (use_peft=True); "
                "full-tree training needs bf16 params"
            )
        if self._quantized_base and not config.fix_vit:
            raise ValueError(
                "LoRA over a quantized base needs fix_vit=True: the rollouts carry the adapters as side "
                "products in the decoder layers, where the ViT's adapters have no place"
            )
        self.mesh = mesh
        self.tp = mesh_size(mesh, MODEL_AXIS)
        if self.tp > 1:
            if self._quantized_base:
                raise NotImplementedError("a quantized trained tree with model > 1: fused int8 columns cannot "
                                          "TP-split (JAX cli/evaluate.py:172; ROADMAP A13)")
            check_heads(cfg, self.tp)
        self._group = data_group(mesh)
        self._model_group = model_group(mesh)
        self._ranks = 1 if self._group is None else dist.get_world_size(self._group)
        self._cp = None
        if config.context_parallel_size > 1:
            if mesh is None:
                raise ValueError("context_parallel_size > 1 needs a device mesh")
            if self._ranks != config.context_parallel_size:
                raise ValueError(f"context_parallel_size={config.context_parallel_size} must equal the mesh data "
                                 f"axis ({self._ranks})")
            config.shared_prefix_loss = False  # CP splits the sequence of full rows
            self._cp = ContextParallel(self._group, config.context_parallel_layout)
        # the ranks that split the data: each rank under data parallelism, the
        # whole group under context parallelism (its first rank rolls out)
        self.data_ranks = 1 if self._cp is not None else self._ranks
        self._data_rank = 0 if self._group is None or self._cp is not None else dist.get_rank(self._group)
        # model-rank 0 of each model group rolls out (under CP, the group's first rank)
        self._rolls_out = (self._cp is None or self._cp.rank == 0) and mesh_coordinate(mesh, MODEL_AXIS) == 0
        self._writes = mesh is None or dist.get_rank() == 0  # under a mesh, global rank 0 writes
        self.device = resolve_device(device)
        self.cfg = cfg
        self.processor = processor
        self.reward_funcs = list(reward_funcs)
        self.metric_funcs = list(metric_funcs)
        self.c = config
        self.video_loader = video_loader
        self.dtype = dtype
        self.params = params
        self.lora = None
        if config.use_peft:
            self.lora_cfg = LoRAConfig(rank=config.lora_r, alpha=config.lora_alpha)
            lora = init_lora(params, self.lora_cfg, seed=config.seed,
                             fused_splits=fused_splits_for(cfg.text) if self._fused_base else None)
            if config.fix_vit:
                lora.pop("visual", None)
            if not lora:
                raise ValueError("use_peft=True found no adaptable weights in this base (an int4 base serves "
                                 "only; train over int8 or bf16)")
            self.lora = lora
            if config.beta != 0.0 and ref_params is None:
                ref_params = params  # the adapter-disable trick: the unmerged base is the reference
        self.ref_params = ref_params if config.beta != 0.0 else None
        # a full-parameter trainer on a mesh, and a LoRA trainer on one with
        # model > 1, keep the policy (the frozen base) and the reference
        # sharded by the rule table (the engine gets a gathered copy); the
        # adapters stay whole
        self.shard = None
        if mesh is not None and (not config.use_peft or self.tp > 1):
            nkv = cfg.text.num_key_value_heads
            self.shard = dataclasses.replace(ShardContext.build(mesh, params).with_kv_heads(nkv),
                                             kv_group=kv_replica_group(mesh, nkv))
            self._whole_numels = [p.numel() for p in trainable_leaves(params, config.fix_vit)]
            base_is_ref = config.use_peft and self.ref_params is params
            self.params = self.shard.shard(params)
            if self.ref_params is not None:
                self.ref_params = self.params if base_is_ref else self.shard.shard(self.ref_params)
        # int8 KV rides with quantized weights, as in the JAX trainer: the
        # rollout samples through the quantized policy and the loss recomputes
        # its log-probs in bf16. A quantized base is already the rollout form:
        # the engine shares it and is not asked to quantize it again.
        self.engine = Engine(params, cfg, dtype=dtype, device=self.device,
                             quantization=(config.rollout_quantization or None) if not self._quantized_base else None,
                             kv_cache_quant=bool(config.rollout_quantization))
        if self.shard is not None and not self._rolls_out:
            self.engine.params = None  # a rank that does not roll out keeps no whole copy
        self.hp = GRPOHyperParams(
            num_generations=config.num_generations,
            beta=config.beta,
            use_grpo=config.use_grpo,
            fix_vit=config.fix_vit,
            gradient_checkpointing=(config.remat_policy or "full") if config.gradient_checkpointing else False,
        )
        # fix_vit: the rollout prefill keeps the frozen blocks' output and the
        # loss and ref forwards reuse it (one ViT-blocks pass per step); not
        # under a mesh, as in JAX
        self.engine.capture_vision_hidden = config.fix_vit and mesh is None
        self.opt_state = None
        self._setup_optimizer(config.learning_rate)
        self._metrics: dict[str, list] = {}
        self.global_step = 0
        self._rng = np.random.default_rng(config.seed)
        self.timers = PhaseTimers()
        # report_to is a comma list as in HF ("tensorboard,wandb"); a sink
        # whose backend is missing is left out with a notice
        self._tb = None
        sinks = [s.strip() for s in (config.report_to or "none").split(",")]
        sink_objs = []
        logdir = config.logging_dir or os.path.join(config.output_dir, "tb")
        if not self._writes:  # one rank writes the logs
            sinks = []
        if "tensorboard" in sinks:
            try:
                from ..utils.logging_sinks import TensorBoardSink

                sink_objs.append(TensorBoardSink(logdir))
            except Exception as e:  # tensorboard is optional
                print(f"[trainer] tensorboard sink unavailable: {e}")
        if "wandb" in sinks:
            try:
                from ..utils.logging_sinks import WandbSink

                sink_objs.append(WandbSink(logdir, run_name=config.run_name))
            except Exception as e:
                print(f"[trainer] wandb sink unavailable: {e}")
        if sink_objs:
            self._tb = _MultiSink(sink_objs)
        self._debug_log = DebugRewardLog()

    # ------------------------------------------------------------------
    def _setup_optimizer(self, learning_rate) -> None:
        """clip_by_global_norm + adamw, inside MultiSteps when accumulating,
        with a fixed lr or a schedule. The first call makes the optimizer
        state (in host memory with offload_optimizer); a later one (train()'s
        schedule) keeps the state the trainer holds and starts the schedule at
        its update count."""
        c = self.c
        self.optimizer = AdamWMultiSteps(
            learning_rate, b1=c.adam_beta1, b2=c.adam_beta2, eps=c.adam_epsilon,
            weight_decay=c.weight_decay, max_grad_norm=c.max_grad_norm,
            every_k=max(c.gradient_accumulation_steps, 1),
            schedule_start=0 if self.opt_state is None else self.opt_state.count,
        )
        group = None if self._cp is not None or self._ranks == 1 else self._group
        if self.lora is not None:
            if self.opt_state is None:
                self.opt_state = self.optimizer.init(lora_leaves(self.lora), offload=c.offload_optimizer)
            self._train_step = make_lora_train_step(self.cfg, self.hp, self.optimizer, self.lora_cfg, group=group,
                                                    cp=self._cp, shard=self.shard)
            return
        numels = None if self.shard is None else self._whole_numels  # the offload rule reads the whole leaves
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(trainable_leaves(self.params, self.hp.fix_vit),
                                                 offload=c.offload_optimizer, numels=numels)
        self._train_step = make_train_step(self.cfg, self.hp, self.optimizer, cp=self._cp, group=group,
                                           shard=self.shard)

    # ------------------------------------------------------------------
    def _log_metric(self, key: str, value: float):
        self._metrics.setdefault(key, []).append(float(value))

    def pop_metrics(self) -> dict:
        self.opt_state.wait()  # offload: the update's copies into host memory have landed
        out = {k: sum(v) / len(v) for k, v in self._metrics.items() if v}
        self._metrics.clear()
        if self._ranks > 1:
            out = self._gather_metrics(out)
        return out

    def _registry_keys(self) -> list[str]:
        """Every metric key this configuration can log, the same list on every
        rank (the gather iterates it, never a rank's own keys, which depend on
        its data: a metric function may return nothing for a rank's rows)."""
        keys = ([f"rewards/{fn.__name__}" for fn in self.reward_funcs]
                + [f"metrics/{fn.__name__}" for fn in self.metric_funcs]
                + ["reward", "reward_std", "completion_length", "generation_entropy", "grad_norm", "loss"])
        if self.c.beta != 0.0:
            keys.append("kl")
        if not self.c.use_grpo:
            keys += ["clip_ratio/low_mean", "clip_ratio/high_mean", "clip_ratio/region_mean"]
        return sorted(set(keys))

    def _gather_metrics(self, metrics: dict) -> dict:
        """The mean over the ranks of each registry key, over the ranks that
        logged it: a [values | presence] f32 vector in the registry's order is
        gathered (JAX's `_gather_metrics`). Presence is a 0/1 mask, so a rank
        whose metric went NaN poisons the mean instead of dropping out."""
        keys = self._registry_keys()
        vals = np.asarray([metrics.get(k, 0.0) for k in keys], np.float32)
        present = np.asarray([float(k in metrics) for k in keys], np.float32)
        vec = torch.from_numpy(np.concatenate([vals, present])).to(self.device)
        gathered = all_gather_vector(vec, self._group).cpu().numpy()  # (ranks, 2K)
        K = len(keys)
        gv, gp = gathered[:, :K], gathered[:, K:]
        out = {}
        for i, k in enumerate(keys):
            n = gp[:, i].sum()
            if n:
                out[k] = float((gv[:, i] * gp[:, i]).sum() / n)
        for k, v in metrics.items():  # keys outside the registry stay this rank's
            out.setdefault(k, v)
        return out

    def _load_frames(self, example: dict):
        """Video frames: offline-preprocessed arrays when available
        (`preprocessed_path/video.npz`, the fine-tuning recipe's), else a
        live decode and budgeted resize by `video_loader`."""
        c = self.c
        pp = example.get("preprocessed_path") or ""
        if pp and os.path.exists(os.path.join(pp, "video.npz")):
            with np.load(os.path.join(pp, "video.npz")) as z:
                return z["video"].astype(np.float32), float(z["fps"])
        if self.video_loader is None:
            raise ValueError("GRPOTrainer needs a video_loader to decode the example's video")
        ele = {
            "video": example["video_path"],
            "total_pixels": c.total_pixels,
            "min_pixels": c.min_pixels,
        }
        if example.get("video_start") is not None:
            ele["video_start"] = example["video_start"]
        if example.get("video_end") is not None:
            ele["video_end"] = example["video_end"]
        return self.video_loader(ele)

    def _stage(self, patches: np.ndarray) -> torch.Tensor:
        """The patches on the trainer's device in its dtype. On the card the
        f32 rows go from pinned memory without blocking the host and are cast
        there, both on the device's default stream: the stream that the
        engine and the loss launch on, so every later use is ordered after
        the copy, whichever thread called this."""
        host = torch.from_numpy(patches)
        if self.device.type != "cuda":
            return host.to(self.dtype)
        with torch.cuda.stream(torch.cuda.default_stream(self.device)):
            return host.pin_memory().to(self.device, non_blocking=True).to(self.dtype)

    def prepare_requests(self, examples: Sequence[dict]) -> list:
        """Host preprocessing for a batch of examples: video decode, budgeted
        resize, chat template, tokenizer and patchify → engine Requests, their
        patches staged on the trainer's device in its dtype (so the engine's
        and the loss batch's moves to the device have nothing left to copy).

        It writes no trainer state, so it may run on a prefetch thread while
        the device computes the previous step, and its result be passed to
        `step_batch` as `requests`."""
        c = self.c
        requests = []
        for example in examples:
            frames, sample_fps = self._load_frames(example)
            conv = make_conversation_video(example, c.prompt_type, c.total_pixels, c.min_pixels)
            prompt_text = self.processor.apply_chat_template(conv, add_generation_prompt=True)
            proc = self.processor(text=[prompt_text], videos=[np.asarray(frames)], fps=[sample_fps])
            prompt_ids = proc.input_ids[0][proc.attention_mask[0] == 1].tolist()
            grid = tuple(int(x) for x in proc.video_grid_thw[0])
            requests.append(Request(prompt_ids, self._stage(proc.pixel_values_videos), grid,
                                    proc.second_per_grid_ts[0]))
        return requests

    def step_batch(self, examples: Sequence[dict], requests: Optional[list] = None) -> dict:
        """One optimizer micro-step on P examples (P·G rollout rows, advantages
        normalised within each example's group). `requests` are the examples'
        engine Requests (`prepare_requests`' output, perhaps from a prefetch
        thread); None builds them here, in the host_preproc phase."""
        c = self.c
        groups = rewards_all = None
        if self._rolls_out or self.shard is not None:  # over shards the gather is every rank's collective
            with self.timers.phase("weight_sync"):
                self._sync_engine()
        if self._rolls_out:
            groups, rewards_all = self._roll_out(examples, requests)
        if self._cp is not None or self.tp > 1:
            with self.timers.phase("batch_broadcast"):
                groups, rewards_all = self._broadcast_groups(groups, rewards_all)

        with self.timers.phase("batch_build"):
            if c.shared_prefix_loss:
                batch = build_grpo_split_batch(self.cfg, groups, dtype=self.dtype, device=self.device)
            else:
                batch = build_grpo_batch_groups(self.cfg, groups, dtype=self.dtype, device=self.device,
                                                pad_multiple=None if self._cp is None else self._cp.multiple)
        batch = align_vision(self.cfg, batch, self.shard)
        if self.hp.fix_vit and batch.vision is not None:
            with self.timers.phase("vision_frozen"):
                cap = self.engine.captured_vision
                grids = [g["grid_thw"] for g in groups if g.get("grid_thw") is not None]
                if cap is not None and cap[0] == vision_signature(grids, batch.vision):
                    batch = batch._replace(vision_hidden=cap[1])
                else:
                    batch = precompute_frozen_vision(self.params, self.cfg, batch, self.shard)
        if self.ref_params is not None:
            with self.timers.phase("ref_logps"):
                batch = batch._replace(ref_logps=compute_ref_logps(self.ref_params, self.cfg, self.hp, batch,
                                                                   cp=self._cp, shard=self.shard))

        with self.timers.phase("train_step"):
            if self.lora is not None:
                self.lora, self.opt_state, loss, metrics = self._train_step(self.params, self.lora, self.opt_state,
                                                                           batch)
            else:
                self.params, self.opt_state, loss, metrics = self._train_step(self.params, self.opt_state, batch)
        for k, v in metrics.items():
            self._log_metric(k, float(v))
        self.global_step += 1
        return {"loss": float(loss), "reward": float(rewards_all.mean())}

    def _roll_out(self, examples, requests):
        """Host preprocessing (when `requests` is None), the G-way rollouts
        and their scoring → (groups, rewards)."""
        c = self.c
        if requests is None:
            with self.timers.phase("host_preproc"):
                requests = self.prepare_requests(examples)
        sp = SamplingParams(
            temperature=c.temperature,
            max_new_tokens=c.max_completion_length,
            stop_token_ids=(self.cfg.eos_token_id,),
            num_return_sequences=c.num_generations,
            seed=int(self._rng.integers(0, 2**31 - 1)),
        )
        with self.timers.phase("rollout"):
            all_completions = self.engine.generate(requests, sp)  # row-major P·G
        with self.timers.phase("rewards_host"):
            return self._score_rollouts(examples, requests, all_completions)

    def _broadcast_groups(self, groups, rewards_all):
        """The rolling-out rank's scored groups, rewards and the metrics their
        scoring logged, to every rank that trains on them (the
        context-parallel group, the model group, or with both every rank of
        the mesh, from global rank 0), as host objects (patches as CPU
        tensors), so that every rank builds the same batch and logs the same
        metrics."""
        if self._cp is not None and self.tp > 1:
            group, src = None, 0  # the mesh spans the process group (`make_mesh`)
        else:
            group = self._group if self._cp is not None else self._model_group
            src = dist.get_global_rank(group, 0)
        box = [None]
        if self._rolls_out:
            box = [([dict(g, patches=None if g["patches"] is None else torch.as_tensor(g["patches"]).cpu())
                     for g in groups], rewards_all, self._rollout_metrics)]
        dist.broadcast_object_list(box, src=src, group=group)
        groups, rewards_all, logged = box[0]
        if not self._rolls_out:
            for k, v in logged:
                self._log_metric(k, v)
        return groups, rewards_all

    def _prepare(self, examples):
        """prepare_requests on a rank that rolls out; None on the others."""
        return self.prepare_requests(examples) if self._rolls_out else None

    def _sync_engine(self) -> None:
        """The live policy into the engine, once a step_batch. Sharded: every
        rank gathers the policy and the rank that rolls out keeps it as the
        engine's tree, quantized one layer at a time with rollout_quantization
        (the old copy dropped first). Full-parameter on one process: the same
        tensors (a re-quantization pass with rollout_quantization).
        LoRA over an int8 base: the adapters as side products, with no merge
        and no copy; over a bf16 base with rollout_quantization: the old
        quantized copy dropped, then a new one merged and quantized one layer
        at a time; otherwise the merged tree. LoRA over shards: the base
        gathered and the adapters merged one layer at a time (and quantized)
        on the rank that rolls out."""
        if self.shard is not None:
            self.engine.params = None
            q = self.c.rollout_quantization
            tree = self._gathered_policy(keep=self._rolls_out, bits=QBITS[q] if q else None)
            if self._rolls_out:
                self.engine.set_params(tree, prequantized=bool(q))
        elif self.lora is None:
            self.engine.set_params(self.params)
        elif self._quantized_base:
            layers, rest = lora_layers_tree(self.lora)
            assert not rest, "side-path adapters live in the decoder layers"
            self.engine.set_lora_side(layers, self.lora_cfg.scaling)
        elif self.c.rollout_quantization:
            self.engine.params = None
            self.engine.set_params(merge_quantize(self.params, self.lora, self.lora_cfg,
                                                  bits=QBITS[self.c.rollout_quantization]), prequantized=True)
        else:
            self.engine.set_params(self._policy_params())

    @torch.no_grad()
    def _policy_params(self) -> dict:
        """The current policy's weights: the params, or under LoRA the base
        merged with the live adapters. Over an int8 base there is no merged
        tree (that is what the base is for): the base itself, whose adapters
        ride beside it."""
        if self.lora is None or self._quantized_base:
            return self.params
        return merge_lora(self.params, self.lora, self.lora_cfg)

    @torch.no_grad()
    def gathered_params(self, keep: bool = True, to=None) -> Optional[dict]:
        """The whole policy: the params, or over shards the tree gathered
        from every rank's blocks (every rank calls it; keep=False takes part
        and keeps nothing); under LoRA the base merged with the adapters."""
        if self.shard is None:
            return self._policy_params()
        return self._gathered_policy(keep=keep, to=to)

    @torch.no_grad()
    def _gathered_policy(self, keep: bool, to=None, bits: Optional[int] = None) -> Optional[dict]:
        """The policy gathered from every rank's blocks (`gather_params`),
        under LoRA with each layer's adapters merged as it is gathered, and
        with `bits` each layer quantized then and the ends after (the
        rollout copy): one whole bf16 layer at a time."""
        dec, rest = lora_layers_tree(self.lora) if self.lora is not None else (None, {})

        def adapters(sub, like):  # the whole adapters where the gathered leaves are (a save's: the host)
            return {k: {n: t.detach().to(like.device) for n, t in ab.items()} for k, ab in sub.items()}

        def text_layer(lp, li):
            if dec is not None and dec[li]:
                lp = apply_layer_lora(lp, adapters(dec[li], next(iter(lp.values()))), self.lora_cfg.scaling)
            return quantize_layer(lp, bits=bits, fuse=True) if bits else lp

        tree = gather_params(self.params, self.shard, keep=keep, to=to, text_layer=text_layer)
        if tree is None:
            return None
        if rest:
            blocks = rest["visual"]["blocks"]
            tree = dict(tree, visual=dict(tree["visual"], blocks=[
                apply_layer_lora(bp, adapters(sub, bp["qkv_w"]), self.lora_cfg.scaling)
                for bp, sub in zip(tree["visual"]["blocks"], blocks)]))
        if bits:
            tree = dict(tree, text=quantize_text_params(tree["text"], bits=bits))
        return tree

    def _log_rollout_metric(self, key: str, value: float):
        self._log_metric(key, value)
        self._rollout_metrics.append((key, float(value)))

    def _score_rollouts(self, examples, requests, all_completions):
        """Host scoring of a step's P·G rollouts: decode the texts, run the
        reward and metric functions, compute the group advantages, and build
        the loss batch's group dicts. The metrics it logs are also kept in
        `_rollout_metrics` for `_broadcast_groups`."""
        G = self.c.num_generations
        self._rollout_metrics = []
        groups, rewards_all = [], []
        for ei, (example, req) in enumerate(zip(examples, requests)):
            completions = all_completions[ei * G: (ei + 1) * G]
            completion_texts = self.processor.batch_decode(
                [self._strip_stop(cmp) for cmp in completions], skip_special_tokens=True
            )
            reward_kwargs = {k: [example[k]] * G for k in example.keys() if k not in ("prompt", "completion")}
            rewards_per_func = np.zeros((G, len(self.reward_funcs)), np.float32)
            for i, fn in enumerate(self.reward_funcs):
                out = fn(completions=completion_texts, **reward_kwargs)
                rewards_per_func[:, i] = [0.0 if r is None else float(r) for r in out]
            rewards = rewards_per_func.sum(axis=1)
            if self._debug_log.enabled:
                for g in range(G):
                    self._debug_log.log_reward(completion_texts[g], None, example.get("solution"),
                                               float(rewards[g]))
            for i, fn in enumerate(self.reward_funcs):
                self._log_rollout_metric(f"rewards/{fn.__name__}", rewards_per_func[:, i].mean())
            for fn in self.metric_funcs:
                vals = [v for v in fn(completions=completion_texts, **reward_kwargs) if v is not None]
                if vals:
                    self._log_rollout_metric(f"metrics/{fn.__name__}", float(np.mean(vals)))
            rewards_all.append(rewards)
            groups.append({
                "prompt_ids": req.input_ids,
                "completions": completions,
                "patches": req.patches,
                "grid_thw": req.grid_thw,
                "second_per_grid_t": req.second_per_grid_t,
            })

        rewards_all = np.concatenate(rewards_all)
        advantages = compute_group_advantages(rewards_all, G)
        for i, g in enumerate(groups):
            g["advantages"] = advantages[i * G: (i + 1) * G]
        self._log_rollout_metric("reward", rewards_all.mean())
        self._log_rollout_metric("reward_std", rewards_all.reshape(-1, G).std(axis=1, ddof=1).mean())
        return groups, rewards_all

    def _strip_stop(self, comp):
        # decode for rewards without the stop token (skip_special_tokens parity)
        return [t for t in comp if t != self.cfg.eos_token_id]

    # ------------------------------------------------------------------
    def train(self, dataset: Sequence[dict], log_fn: Optional[Callable] = None, max_steps: Optional[int] = None):
        """The epoch loop, with per-epoch checkpoints and early stopping.

        max_steps (in global_step units, i.e. micro-steps): a hard stop for a
        resumed run, which trains exactly its quota (the reference recomputes
        and enforces it from trainer_state.json, main.py:589-618).

        The lr schedule (linear: a warmup over warmup_ratio of the updates,
        then a decay to 0) counts the updates from this call on. It is built
        without touching the optimizer state the trainer holds, so a restored
        state keeps its moments and counts."""
        c = self.c
        # data parallelism: this rank's shard, every shard as long as the
        # longest (HF DistributedSampler's wrap, by modular repetition so that
        # a dataset smaller than the ranks still fills each shard): a rank
        # whose shard ran out would leave the others' collectives hanging
        shard = list(dataset)
        if self.data_ranks > 1:
            total = math.ceil(len(shard) / self.data_ranks) * self.data_ranks
            shard = [shard[i % len(shard)] for i in range(total)][self._data_rank::self.data_ranks]
        micro_per_epoch = math.ceil(len(shard) / max(int(c.per_device_train_batch_size), 1))
        steps_per_epoch = math.ceil(micro_per_epoch / c.gradient_accumulation_steps)
        n_epochs = 1 if c.is_early_stopping else int(math.ceil(c.num_train_epochs))
        if c.lr_scheduler_type == "linear":
            total_updates = max(steps_per_epoch * n_epochs, 1)
            warmup = int(total_updates * c.warmup_ratio)
            schedule = join_schedules(
                [linear_schedule(0.0, c.learning_rate, max(warmup, 1)),
                 linear_schedule(c.learning_rate, 0.0, max(total_updates - warmup, 1))],
                boundaries=[warmup],
            ) if warmup else linear_schedule(c.learning_rate, 0.0, total_updates)
            self._setup_optimizer(schedule)
        bs = max(int(c.per_device_train_batch_size), 1)
        # one batch ahead: the host preprocessing (video decode, resize,
        # template, patchify, staging) of batch k+1 runs on one worker thread
        # while the device computes step k; in-order submission keeps the
        # order, and a worker's exception reaches this thread at .result()
        batches = [(epoch, shard[i:i + bs]) for epoch in range(n_epochs) for i in range(0, len(shard), bs)]
        prefetch = ThreadPoolExecutor(max_workers=1)
        try:
            pending = prefetch.submit(self._prepare, batches[0][1]) if batches else None
            for bi, (epoch, examples) in enumerate(batches):
                if max_steps is not None and self.global_step >= max_steps:
                    return
                with self.timers.phase("host_preproc_wait"):
                    requests = pending.result()
                if bi + 1 < len(batches):
                    pending = prefetch.submit(self._prepare, batches[bi + 1][1])
                self.step_batch(examples, requests=requests)
                if self.global_step % c.logging_steps == 0:
                    logs = {"epoch": epoch, "step": self.global_step, **self.pop_metrics()}
                    if self._tb is not None:
                        self._tb.log(logs, self.global_step)
                    (log_fn or print)(logs)
                # the save cadence counts optimizer steps, as HF's Trainer
                # does: with accumulation 2 and save_steps 50, micro-steps
                # 100, 200, ...
                accum = max(int(c.gradient_accumulation_steps), 1)
                opt_step, in_window = divmod(self.global_step, accum)
                if c.save_strategy == "steps" and in_window == 0 and opt_step % c.save_steps == 0:
                    self.save_checkpoint(os.path.join(c.output_dir, f"checkpoint-{opt_step}"))
                if bi + 1 == len(batches) or batches[bi + 1][0] != epoch:  # the epoch's last batch
                    if c.save_strategy == "epoch":
                        self.save_checkpoint(os.path.join(c.output_dir, f"checkpoint-{self.global_step}"))
                    self.save_checkpoint(os.path.join(c.output_dir, f"epoch-{epoch + 1}"))
        finally:
            prefetch.shutdown(wait=False, cancel_futures=True)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str):
        """params (and, with save_only_model False, the optimizer state),
        trainer_state.json, the model config, the processor's tokenizer files
        and a model card. With the tokenizer beside the weights, the SF loop's
        evaluate and its next round's train load the directory as a model
        (the JAX package writes no tokenizer: ROADMAP §C). Over ranks, global
        rank 0 writes and every rank waits for it; over shards every rank
        first takes part in gathering the params (and the optimizer state)
        to rank 0's host memory, leaf by leaf."""
        self.opt_state.wait()
        params = opt_tree = None
        if self.shard is not None:
            params = self.gathered_params(keep=self._writes, to="cpu")
            if not self.c.save_only_model and self.lora is None:  # LoRA's state is whole on every rank
                opt_tree = self._gathered_opt_tree(keep=self._writes)
        if self._writes:  # one rank writes; the others wait at the barrier
            self._write_checkpoint(path, params, opt_tree)
        if self.mesh is not None and dist.get_world_size() > 1:
            dist.barrier()

    def _opt_specs(self) -> dict:
        """The spec tree of `opt_state.tree()`: each state list's leaves
        sharded as their parameters."""
        from ..parallel.sharding import Spec

        specs = trainable_leaves(self.shard.specs, self.hp.fix_vit)
        out = {"count": Spec(()), "mini_step": Spec(()), "mu": specs, "nu": specs}
        if self.opt_state.acc is not None:
            out["acc"] = specs
        return out

    @torch.no_grad()
    def _gathered_opt_tree(self, keep: bool) -> Optional[dict]:
        """The optimizer state's tree with its blocks gathered whole (host
        memory on a rank that keeps it)."""
        return gather_params(self.opt_state.tree(), dataclasses.replace(self.shard, specs=self._opt_specs()),
                             keep=keep, to="cpu")

    def _write_checkpoint(self, path: str, params=None, opt_tree=None):
        os.makedirs(path, exist_ok=True)
        # a LoRA run saves the merged model (over an int8 base, the base) and
        # the adapters beside it, in the JAX package's format
        save_params(path, self._policy_params() if params is None else params)
        if self.lora is not None:
            save_lora_npz(os.path.join(path, LORA_FILE), self.lora, self.cfg)
        if hasattr(self.processor, "save_pretrained"):  # a processor of ids only (chip_smoke.py) has none
            self.processor.save_pretrained(path)
        if not self.c.save_only_model:
            # the full training state (HF --save_only_model false): a resume
            # restores the moments and the accumulation and schedule counts
            save_params(path, self.opt_state.tree() if opt_tree is None else opt_tree, name="opt_state")
        with open(os.path.join(path, "trainer_state.json"), "w") as f:
            json.dump({"global_step": self.global_step}, f)
        with open(os.path.join(path, NATIVE_CONFIG), "w") as f:
            json.dump(config_to_plain_dict(self.cfg), f)
        self.save_model_card(path)

    def load_checkpoint_state(self, path: str):
        """Restore params, global_step and (when saved) the optimizer state,
        in place: the engine and the optimizer hold the same tensors.

        LoRA: a checkpoint with adapters restores them (and their optimizer
        state) over the base this trainer was built with, which stays as it
        is. Over an int8 base a checkpoint without adapters is refused. Over a
        bf16 base, a checkpoint of merged weights only becomes the new base
        under the trainer's own adapters (fresh at a resume), and its
        optimizer state, if any, is skipped: it belongs to adapters that are
        gone."""
        self.opt_state.wait()  # offload: no copy of the last update may land over the restored state
        restore_opt = True
        if self.lora is not None:
            lora_path = os.path.join(path, LORA_FILE)
            if os.path.exists(lora_path):
                _copy_tree(lora_from_jax(load_lora_npz(lora_path), self.cfg, device=self.device), self.lora)
            elif self._quantized_base:
                raise ValueError(f"a quantized-base resume needs {lora_path}: this checkpoint has no adapters; "
                                 "pass it as --model_name_or_path to start a new run instead")
            else:
                load_params_into(path, self.params,
                                 block=None if self.shard is None else self._block_of(self.shard.specs))
                restore_opt = False
        elif self.shard is not None:  # every rank reads the whole tree and keeps its blocks
            load_params_into(path, self.params, block=self._block_of(self.shard.specs))
        else:
            load_params_into(path, self.params)  # refuses an orbax directory, and a tree of another shape
        if self.shard is None:  # over shards the next step_batch's weight_sync gathers the restored policy
            self._sync_engine()
        state_path = os.path.join(path, "trainer_state.json")
        if os.path.exists(state_path):
            with open(state_path) as f:
                self.global_step = json.load(f).get("global_step", self.global_step)
        if restore_opt and is_native_checkpoint(path, "opt_state"):
            tree = self.opt_state.tree()
            load_params_into(path, tree, name="opt_state",
                             block=None if self.shard is None or self.lora is not None
                             else self._block_of(self._opt_specs()))
            self.opt_state.load_tree(tree)

    def _block_of(self, specs):
        """(checkpoint key, whole leaf) -> this rank's block, by the spec at
        that key of `specs` (a tree shaped like what was saved)."""
        def block(key: str, leaf: torch.Tensor) -> torch.Tensor:
            spec = specs
            for part in key.split("."):
                spec = spec[int(part)] if isinstance(spec, list) else spec[part]
            return shard_leaf(leaf, spec, self.shard.sizes, self.shard.coords)
        return block

    def save_model_card(self, path: str):
        """A draft model card (timer1_trainer.py:795-857)."""
        card = (
            "# GRPO-trained Qwen2.5-VL (Time-R1 TPU)\n\n"
            "Trained with Group Relative Policy Optimization "
            "([DeepSeekMath](https://huggingface.co/papers/2402.03300)) on "
            "temporal video grounding with verifiable tIoU/format rewards.\n\n"
            f"- global_step: {self.global_step}\n"
            f"- num_generations (G): {self.c.num_generations}\n"
            f"- temperature: {self.c.temperature}\n"
            f"- beta (KL): {self.c.beta}\n"
            f"- loss: {'vanilla GRPO' if self.c.use_grpo else 'PPO-clip (eps=0.2)'}\n"
            f"- reward_funcs: {[f.__name__ for f in self.reward_funcs]}\n"
        )
        with open(os.path.join(path, "README.md"), "w") as f:
            f.write(card)


@torch.no_grad()
def _copy_tree(src, dst) -> None:
    """Copy a tree of tensors into one of the same structure, in place (the
    adapters that the optimizer state and the engine refer to)."""
    if isinstance(dst, dict):
        if set(src) != set(dst):
            raise ValueError(f"adapters differ: {sorted(src)} against {sorted(dst)}")
        for k in dst:
            _copy_tree(src[k], dst[k])
    elif isinstance(dst, list):
        if len(src) != len(dst):
            raise ValueError(f"adapters of {len(src)} layers against {len(dst)}")
        for a, b in zip(src, dst):
            _copy_tree(a, b)
    else:
        if src.shape != dst.shape:
            raise ValueError(f"an adapter of shape {tuple(src.shape)} against {tuple(dst.shape)}")
        dst.copy_(src)
