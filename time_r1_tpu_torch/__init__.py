"""Time-R1 in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of `time_r1_tpu` (JAX on a TPU), which stays in the repository as the
reference. This package imports torch and never jax, and nothing of
`time_r1_tpu`. Its kernels are CUDA C++ written for sm_90a (`csrc/`), built
at first use by `kernels.py`.

Ported so far: the serving path of Qwen2.5-VL at one sequence per prompt
(`sampler.engine.Engine.generate`): patchify → vision tower (K2, K3) →
chunked prefill (K1) → greedy or sampled decode.
"""
