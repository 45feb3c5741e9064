"""Flash attention forward (K1): the wrapper of `csrc/flash_attention.cu` and its
plain version.

Replaces the Pallas kernel of `time_r1_tpu/ops/flash_attention.py`
(`_flash_fwd`, pallas_call at :135; `flash_attention` at :270). Given CUDA
tensors the wrapper launches the kernel (or raises); given CPU tensors it runs
`flash_attention_plain`, which computes the same function in plain torch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels
from .attention import NEG_INF


def flash_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    kv_bias: torch.Tensor,  # (B, Skv) f32 additive (0 or NEG_INF)
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32), computed in f32."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = D**-0.5
    qg = q.float().reshape(B, Sq, Hkv, G, D) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s + kv_bias.float()[:, None, None, None, :]
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l_safe, v.float())
    lse = (m + torch.log(l_safe)).reshape(B, H, Sq)
    return out.reshape(B, Sq, H, D).to(q.dtype), lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse). CUDA tensors launch K1; CPU tensors run the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, kv_bias, causal, scale, q_offset)
    name = "flash_attention"
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kernels.require(q.dtype in kernels.DTYPE_CODE, name, f"dtype {q.dtype}")
    kernels.require(k.dtype == q.dtype and v.dtype == q.dtype, name, "q/k/v dtypes differ")
    kernels.require(kv_bias.dtype == torch.float32, name, "kv_bias must be float32")
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in (q, k, v, kv_bias)),
                    name, "operands must be contiguous CUDA tensors")
    kernels.require(k.shape == (B, Skv, Hkv, D) and v.shape == k.shape, name, "k/v shape")
    kernels.require(kv_bias.shape == (B, Skv), name, "kv_bias shape")
    kernels.require(H % Hkv == 0 and D in kernels.ATTN_HEAD_DIMS, name, f"H={H} Hkv={Hkv} D={D}")
    kernels.require(B <= 65535 and H <= 65535, name, "grid too large")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = kernels.bind("flash_attention", "t1_flash_attention_fwd", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ])
    rc = fn(
        kernels.DTYPE_CODE[q.dtype], kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(kv_bias), kernels.ptr(out), kernels.ptr(lse),
        B, Sq, Skv, H, Hkv, D, int(causal), float(scale), int(q_offset), kernels.stream(q),
    )
    kernels.check(rc, name)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    kv_bias: torch.Tensor,  # (B, Skv) f32 additive (0 or NEG_INF)
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention (B, Sq, H, D) with GQA (q head h reads kv head h // G),
    an additive kv bias and causal masking at global row q_offset + i. Rows
    whose keys are all masked (left padding) are finite garbage, as in JAX."""
    return flash_attention_fwd(q, k, v, kv_bias, causal, scale, q_offset)[0]
