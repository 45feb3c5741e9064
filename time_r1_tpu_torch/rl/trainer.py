"""GRPO trainer on one device (port of `time_r1_tpu/rl/trainer.py`).

One `step_batch` is the job the system exists for: G-way rollouts with the
live policy weights (`Engine.generate`, num_return_sequences = G), host
rewards and group advantages, the split-batch loss batch, the frozen ViT's
hidden states taken from the rollout's prefill (fix_vit), the reference
log-probs, then forward, backward and the optimizer micro-step
(clip + AdamW inside MultiSteps, `rl/optim.py`).

Quantized rollouts (`rollout_quantization="int8" | "int4"`) follow the JAX
trainer's full-parameter branch: the engine keeps an int8/int4 copy of the
policy with an int8 KV cache, re-quantized from the live bf16 weights once
per `step_batch` (the weight_sync phase); the loss and the reference forward
stay bf16 over the unquantized tree. A quantized base is trainable only
through LoRA, as in JAX (ValueError).

Not ported yet, each raising NotImplementedError where it is asked for: the
host input path (`prepare_requests`: video decode, chat template, tokenizer;
ROADMAP A4), the full-row loss (`shared_prefix_loss=False`, A7), LoRA (A8),
the training loop around `step_batch`, remat, checkpoints and optimizer
offload (A9), and device meshes and context parallelism (A13).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.qwen25vl import Qwen25VLConfig
from ..models.qwen25vl.model import vision_signature
from ..ops.quant import is_quantized
from ..sampler import Engine, SamplingParams
from ..utils.profiling import PhaseTimers
from .grpo import (
    GRPOHyperParams,
    compute_group_advantages,
    compute_ref_logps,
    make_train_step,
    precompute_frozen_vision,
    trainable_leaves,
)
from .optim import AdamWMultiSteps
from .rollout import build_grpo_split_batch


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


def _unported(config: TrainConfig, mesh) -> Optional[str]:
    if mesh is not None or config.context_parallel_size > 1:
        return "device meshes and context parallelism are not ported yet (ROADMAP A13)"
    if config.use_peft:
        return "LoRA training is not ported yet (ROADMAP A8)"
    if not config.shared_prefix_loss:
        return "the full-row loss (shared_prefix_loss=False) is not ported yet (ROADMAP A7)"
    if config.offload_optimizer or config.gradient_checkpointing:
        return "optimizer offload and gradient checkpointing are not ported yet (ROADMAP A9)"
    return None


class GRPOTrainer:
    """Single-device GRPO trainer. `processor` is anything with
    `batch_decode(list of token lists, skip_special_tokens=True)`; `step_batch`
    takes pre-built engine Requests (the host input path is ROADMAP A4).

    Full-parameter training updates `params` in place; the engine holds the
    same tensors, so the rollouts sample from the live weights with no copy
    (with rollout_quantization it holds a quantized copy, re-made at each
    weight sync).
    With beta ≠ 0, `ref_params` (a separate copy) gives the KL reference, as in
    the JAX trainer, which likewise has no reference without one."""

    def __init__(
        self,
        params: dict,
        cfg: Qwen25VLConfig,
        processor,
        reward_funcs: Sequence[Callable],
        metric_funcs: Sequence[Callable] = (),
        config: Optional[TrainConfig] = None,
        ref_params: Optional[dict] = None,
        dtype=torch.bfloat16,
        mesh=None,
        device="cuda",
    ):
        config = dataclasses.replace(config) if config is not None else TrainConfig()
        lp = params["text"]["layers"][0]
        if is_quantized(lp["qkv"] if "qkv" in lp else lp["q_w"]) and not config.use_peft:
            raise ValueError(
                "a quantized base is trainable via LoRA only (use_peft=True); "
                "full-tree training needs bf16 params"
            )
        why = _unported(config, mesh)
        if why:
            raise NotImplementedError(why)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.processor = processor
        self.reward_funcs = list(reward_funcs)
        self.metric_funcs = list(metric_funcs)
        self.c = config
        self.dtype = dtype
        self.params = params
        self.ref_params = ref_params if config.beta != 0.0 else None
        # int8 KV rides with quantized weights, as in the JAX trainer: the
        # rollout samples through the quantized policy and the loss recomputes
        # its log-probs in bf16
        self.engine = Engine(params, cfg, dtype=dtype, device=self.device,
                             quantization=config.rollout_quantization or None,
                             kv_cache_quant=bool(config.rollout_quantization))
        self.hp = GRPOHyperParams(
            num_generations=config.num_generations,
            beta=config.beta,
            use_grpo=config.use_grpo,
            fix_vit=config.fix_vit,
        )
        # fix_vit: the rollout prefill keeps the frozen blocks' output and the
        # loss and ref forwards reuse it (one ViT-blocks pass per step)
        self.engine.capture_vision_hidden = config.fix_vit
        self._setup_optimizer(config.learning_rate)
        self._metrics: dict[str, list] = {}
        self._rng = np.random.default_rng(config.seed)
        self.timers = PhaseTimers()

    # ------------------------------------------------------------------
    def _setup_optimizer(self, learning_rate: float) -> None:
        """clip_by_global_norm + adamw, inside MultiSteps when accumulating."""
        c = self.c
        self.optimizer = AdamWMultiSteps(
            learning_rate, b1=c.adam_beta1, b2=c.adam_beta2, eps=c.adam_epsilon,
            weight_decay=c.weight_decay, max_grad_norm=c.max_grad_norm,
            every_k=max(c.gradient_accumulation_steps, 1),
        )
        self.opt_state = self.optimizer.init(trainable_leaves(self.params, self.hp.fix_vit))
        self._train_step = make_train_step(self.cfg, self.hp, self.optimizer)

    # ------------------------------------------------------------------
    def _log_metric(self, key: str, value: float):
        self._metrics.setdefault(key, []).append(float(value))

    def pop_metrics(self) -> dict:
        out = {k: sum(v) / len(v) for k, v in self._metrics.items() if v}
        self._metrics.clear()
        return out

    def prepare_requests(self, examples: Sequence[dict]) -> list:
        raise NotImplementedError(
            "the host input path (video decode, chat template, tokenizer) is not ported yet (ROADMAP A4)"
        )

    def step_batch(self, examples: Sequence[dict], requests: Optional[list] = None) -> dict:
        """One optimizer micro-step on P examples (P·G rollout rows, advantages
        normalised within each example's group). `requests` are the examples'
        engine Requests."""
        c = self.c
        G = c.num_generations
        with self.timers.phase("weight_sync"):  # a re-quantization pass with rollout_quantization
            self.engine.set_params(self.params)
        if requests is None:
            with self.timers.phase("host_preproc"):
                requests = self.prepare_requests(examples)

        sp = SamplingParams(
            temperature=c.temperature,
            max_new_tokens=c.max_completion_length,
            stop_token_ids=(self.cfg.eos_token_id,),
            num_return_sequences=G,
            seed=int(self._rng.integers(0, 2**31 - 1)),
        )
        with self.timers.phase("rollout"):
            all_completions = self.engine.generate(requests, sp)  # row-major P·G

        with self.timers.phase("rewards_host"):
            groups, rewards_all = self._score_rollouts(examples, requests, all_completions)

        with self.timers.phase("batch_build"):
            batch = build_grpo_split_batch(self.cfg, groups, dtype=self.dtype, device=self.device)
        if self.hp.fix_vit and batch.vision is not None:
            with self.timers.phase("vision_frozen"):
                cap = self.engine.captured_vision
                grids = [g["grid_thw"] for g in groups if g.get("grid_thw") is not None]
                if cap is not None and cap[0] == vision_signature(grids, batch.vision):
                    batch = batch._replace(vision_hidden=cap[1])
                else:
                    batch = precompute_frozen_vision(self.params, self.cfg, batch)
        if self.ref_params is not None:
            with self.timers.phase("ref_logps"):
                batch = batch._replace(ref_logps=compute_ref_logps(self.ref_params, self.cfg, self.hp, batch))

        with self.timers.phase("train_step"):
            self.params, self.opt_state, loss, metrics = self._train_step(self.params, self.opt_state, batch)
        for k, v in metrics.items():
            self._log_metric(k, float(v))
        return {"loss": float(loss), "reward": float(rewards_all.mean())}

    def _score_rollouts(self, examples, requests, all_completions):
        """Host scoring of a step's P·G rollouts: decode the texts, run the
        reward and metric functions, compute the group advantages, and build
        the loss batch's group dicts."""
        G = self.c.num_generations
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
            for i, fn in enumerate(self.reward_funcs):
                self._log_metric(f"rewards/{fn.__name__}", rewards_per_func[:, i].mean())
            for fn in self.metric_funcs:
                vals = [v for v in fn(completions=completion_texts, **reward_kwargs) if v is not None]
                if vals:
                    self._log_metric(f"metrics/{fn.__name__}", float(np.mean(vals)))
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
        self._log_metric("reward", rewards_all.mean())
        self._log_metric("reward_std", rewards_all.reshape(-1, G).std(axis=1, ddof=1).mean())
        return groups, rewards_all

    def _strip_stop(self, comp):
        # decode for rewards without the stop token (skip_special_tokens parity)
        return [t for t in comp if t != self.cfg.eos_token_id]
