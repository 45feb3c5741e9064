"""Time-R1 in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of `time_r1_tpu` (JAX on a TPU), which stays in the repository as the
reference. This package imports torch and never jax, and nothing of
`time_r1_tpu`. Its kernels are CUDA C++ written for sm_90a (`csrc/`), built
at first use by `kernels.py`.

Ported so far: serving at one or G sequences per prompt
(`sampler.engine.Engine.generate`: patchify → vision tower (K2, K3) →
chunked prefill (K1) → decode), one GRPO training step
(`rl.trainer.GRPOTrainer.step_batch`), quantized rollouts (int8/int4
weights, int8 KV), and continuous-batching serving over a paged KV pool or
contiguous slots (`sampler.paged.PagedEngine`, `sampler.continuous.
ContinuousEngine`, `sampler.text_engine.TextEngine`).
"""
