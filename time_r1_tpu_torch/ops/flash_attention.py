"""Flash attention and its backward, and shared-prefix attention: the wrappers
of the port's CUDA kernels and their plain versions.

- K1 `flash_attention_fwd` (`csrc/flash_attention.cu`) replaces the Pallas
  `_flash_fwd` of `time_r1_tpu/ops/flash_attention.py` (pallas_call at :135).
  bf16 operands launch the tensor-core kernel (`csrc/attention_fwd_tc.cuh`),
  f32 operands the exact f32 FMA one (`csrc/attention_tile.cuh`);
  `.tc_launches` counts the first.
- B1 `flash_bwd_dq` and B2 `flash_bwd_dkv` (`csrc/flash_attention_bwd.cu`)
  replace `_flash_bwd_dq` (:325) and `_flash_bwd_dkv` (:368 grouped, :400 per
  head). `flash_attention` is a `torch.autograd.Function` whose backward runs
  them, as `_flash_vjp_bwd` (:437) does. bf16 operands launch the
  tensor-core kernels (`csrc/attention_bwd_tc.cuh`), f32 operands the exact
  f32 FMA ones (`csrc/attention_bwd.cuh`); `.tc_launches` counts the first.
- S1 `shared_prefix_fwd`, S2 `shared_prefix_bwd_dq` and
  `shared_prefix_bwd_dkv` (`csrc/shared_prefix_attention.cu`) replace `_sp_fwd`
  (:575) and the two kernels of `_sp_vjp_bwd` (:739, :769);
  `flash_attention_shared_prefix` is their autograd Function. bf16 operands
  launch the tensor-core kernels (S1 on `csrc/attention_fwd_tc.cuh`, S2 on
  `csrc/attention_bwd_tc.cuh`), f32 operands the exact f32 FMA ones;
  `.tc_launches` counts the first.

Given CUDA tensors a wrapper launches its kernel (or raises: a bf16 shape
that the tensor-core kernel does not take has no fallback) and adds one to
its `.launches`; given CPU tensors it runs its plain version, which computes
the same function in plain torch (the backward's plain versions are the
explicit FA-2 formulas, so on the CPU the autograd Functions run the same
algorithm as the kernels). What bounds each kernel is in its source's notes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels
from .attention import NEG_INF

BWD_HEAD_DIMS = (64, 128)  # head dims instantiated in csrc/attention_bwd{,_tc}.cuh
SMS = 132  # streaming multiprocessors of an H100 SXM: B2's split fills two blocks on each

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


_FWD_ARGS = [_P] * 6 + [_I] * 7 + [_F, _I, _P]


def _launch(name, symbol, stem, args_types, args):
    fn = kernels.bind(stem, symbol, args_types)
    kernels.check(fn(*args), name)


def _masked_scores(q, k, kv_bias, causal, scale, q_offset):
    """(B, Hkv, G, Sq, Skv) f32 scores of scaled q against k plus the key
    bias, with causally hidden keys set to NEG_INF (not added)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, D) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s + kv_bias.float()[:, None, None, None, :]
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
    return s


def _check_attn(name, q, k, v, kv_bias, head_dims):
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kernels.require(q.dtype in kernels.DTYPE_CODE, name, f"dtype {q.dtype}")
    kernels.require(k.dtype == q.dtype and v.dtype == q.dtype, name, "q/k/v dtypes differ")
    kernels.require(kv_bias.dtype == torch.float32, name, "kv_bias must be float32")
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in (q, k, v, kv_bias)),
                    name, "operands must be contiguous CUDA tensors")
    kernels.require(k.shape == (B, Skv, Hkv, D) and v.shape == k.shape, name, "k/v shape")
    kernels.require(kv_bias.shape == (B, Skv), name, "kv_bias shape")
    kernels.require(H % Hkv == 0 and D in head_dims, name, f"H={H} Hkv={Hkv} D={D}")
    kernels.require(B <= 65535 and H <= 65535, name, "grid too large")


def _check_grads_in(name, q, do, lse, delta_bhs):
    B, Sq, H, _ = q.shape
    kernels.require(do.shape == q.shape and do.dtype == q.dtype and do.is_cuda and do.is_contiguous(),
                    name, "dout must be a contiguous CUDA tensor like q")
    for t, what in ((lse, "lse"), (delta_bhs, "delta")):
        kernels.require(t.dtype == torch.float32 and t.is_cuda and t.is_contiguous()
                        and t.shape == (B, H, Sq), name, f"{what} must be (B, H, Sq) float32")


# ---------------------------------------------------------------------------
# K1: forward


# log2(e): the plain K1 takes its exponentials as exp2(z · log2 e). torch's
# float exp on the CPU can come out ~1e-4 off in a process's first call when
# the machine is loaded (measured: 5 of 32 fresh processes under parallel
# load, each later call exact; exp2 0 of 48), which the K1 parity tests
# against JAX at 2e-5 saw now and then under parallel workers.
LOG2E = 1.4426950408889634


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
    s = _masked_scores(q, k, kv_bias, causal, _scale(q, scale), q_offset)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2((s - m) * LOG2E)
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
    """(out, lse). CUDA tensors launch K1 (bf16: the tensor-core kernel, whose
    16-byte copies need q, k and v on 16 bytes); CPU tensors run the plain
    version."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, kv_bias, causal, scale, q_offset)
    name = "flash_attention"
    _check_attn(name, q, k, v, kv_bias, kernels.ATTN_HEAD_DIMS)
    kernels.require(q.shape[1] > 0 and k.shape[1] > 0, name, "empty query or key range")
    tc = q.dtype == torch.bfloat16
    if tc:
        kernels.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), name, "bf16 operands must be 16-byte aligned")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch(name, "t1_flash_attention_fwd_tc" if tc else "t1_flash_attention_fwd", "flash_attention",
            _FWD_ARGS, [kernels.ptr(t) for t in (q, k, v, kv_bias, out, lse)]
            + [B, Sq, Skv, H, Hkv, D, int(causal), scale, int(q_offset), kernels.stream(q)])
    flash_attention_fwd.launches += 1
    flash_attention_fwd.tc_launches += int(tc)
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0


# ---------------------------------------------------------------------------
# B1, B2: backward


def _p_ds(s, v, do, lse, delta):
    """FA-2's recomputed probabilities p = exp(s − lse) and ds = p·(dO·vᵀ −
    delta), both (B, Hkv, G, Sq, Skv) f32, for scores s against values v
    (B, Skv, Hkv, D), given the GLOBAL lse (B, H, Sq) and delta (B, Sq, H)."""
    B, Hkv, G, Sq, _ = s.shape
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do.float().reshape(B, Sq, Hkv, G, -1), v.float())
    return p, p * (dp - delta.float().permute(0, 2, 1).reshape(B, Hkv, G, Sq, 1))


def flash_bwd_dq_plain(q, k, v, kv_bias, do, lse, delta, causal=True, scale=None, q_offset=0):
    """FA-2 dq = scale·ds·k given the GLOBAL lse and delta, in q's dtype."""
    B, Sq, H, D = q.shape
    scale = _scale(q, scale)
    _, ds = _p_ds(_masked_scores(q, k, kv_bias, causal, scale, q_offset), v, do, lse, delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return dq.reshape(B, Sq, H, D).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, kv_bias, do, lse, delta, causal=True, scale=None, q_offset=0):
    """FA-2 (dk, dv) (B, Skv, Hkv, D) f32, summed over the G q-heads of each
    kv head: dv = pᵀ·dO, dk = dsᵀ·(scale·q)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    scale = _scale(q, scale)
    p, ds = _p_ds(_masked_scores(q, k, kv_bias, causal, scale, q_offset), v, do, lse, delta)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do.float().reshape(B, Sq, Hkv, H // Hkv, D))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(B, Sq, Hkv, H // Hkv, D) * scale)
    return dk, dv


def bwd_dkv_split(G: int, Skv: int, Hkv: int, B: int, R: int = 1) -> int:
    """n_split of the tensor-core dK/dV kernel (B2, and S2's prefix dK/dV with
    R query rows per kv entry): the smallest divisor of R·G whose grid
    (ceil(Skv/64), Hkv·n_split, B kv entries) has at least two blocks per SM,
    else R·G. The kernel gives each block R·G/n_split (row, q head) pairs."""
    blocks = -(-Skv // 64) * Hkv * B
    pairs = R * G
    for n in range(1, pairs + 1):
        if pairs % n == 0 and blocks * n >= 2 * SMS:
            return n
    return pairs


def _bwd_check(name, q, k, v, kv_bias, do, lse, delta_t):
    """The operand checks of B1 and B2; bf16 operands (the tensor-core
    kernels) must also start on 16 bytes, as their 16-byte copies do."""
    _check_attn(name, q, k, v, kv_bias, BWD_HEAD_DIMS)
    _check_grads_in(name, q, do, lse, delta_t)
    kernels.require(q.shape[1] > 0 and k.shape[1] > 0, name, "empty query or key range")
    if q.dtype == torch.bfloat16:
        kernels.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, do)), name,
                        "bf16 operands must be 16-byte aligned")


_DQ_ARGS = [_P] * 8 + [_I] * 7 + [_F, _I, _P]
_DKV_ARGS = [_P] * 9 + [_I] * 7 + [_F, _I, _P]
_DKV_TC_ARGS = [_P] * 11 + [_I] * 8 + [_F, _I, _P]


def flash_bwd_dq(q, k, v, kv_bias, do, lse, delta, causal=True, scale=None, q_offset=0):
    """B1: dq (B, Sq, H, D) in q's dtype. delta is (B, Sq, H) f32."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, kv_bias, do, lse, delta, causal, scale, q_offset)
    name = "flash_bwd_dq"
    scale = _scale(q, scale)
    delta_t = delta.transpose(1, 2).contiguous()
    _bwd_check(name, q, k, v, kv_bias, do, lse, delta_t)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    ptrs = [kernels.ptr(t) for t in (q, k, v, kv_bias, do, lse, delta_t, dq)]
    tail = [B, Sq, Skv, H, Hkv, D, int(causal), scale, int(q_offset), kernels.stream(q)]
    tc = q.dtype == torch.bfloat16
    _launch(name, "t1_flash_bwd_dq_tc" if tc else "t1_flash_bwd_dq", "flash_attention_bwd", _DQ_ARGS,
            ptrs + tail)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.tc_launches += int(tc)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.tc_launches = 0


def flash_bwd_dkv(q, k, v, kv_bias, do, lse, delta, causal=True, scale=None, q_offset=0):
    """B2: (dk, dv) (B, Skv, Hkv, D) f32, summed over the G q-heads of each kv
    head. delta is (B, Sq, H) f32. In bf16 the heads are split over
    `bwd_dkv_split` blocks whose f32 partials one more kernel folds in a fixed
    order; in f32 one block sums them."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, kv_bias, do, lse, delta, causal, scale, q_offset)
    name = "flash_bwd_dkv"
    scale = _scale(q, scale)
    delta_t = delta.transpose(1, 2).contiguous()
    _bwd_check(name, q, k, v, kv_bias, do, lse, delta_t)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    ptrs = [kernels.ptr(t) for t in (q, k, v, kv_bias, do, lse, delta_t, dk, dv)]
    tail = [B, Sq, Skv, H, Hkv, D, int(causal), scale, int(q_offset), kernels.stream(q)]
    if q.dtype == torch.bfloat16:
        n_split = bwd_dkv_split(H // Hkv, Skv, Hkv, B)
        part_ptrs = [_P(), _P()]  # n_split == 1: the blocks write dk, dv themselves
        if n_split > 1:
            parts = torch.empty((2, n_split, *k.shape), dtype=torch.float32, device=q.device)
            part_ptrs = [kernels.ptr(parts[0]), kernels.ptr(parts[1])]
        _launch(name, "t1_flash_bwd_dkv_tc", "flash_attention_bwd", _DKV_TC_ARGS,
                ptrs + part_ptrs + [n_split] + tail)
        flash_bwd_dkv.tc_launches += 1
    else:
        _launch(name, "t1_flash_bwd_dkv", "flash_attention_bwd", _DKV_ARGS, ptrs + tail)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.tc_launches = 0


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """rowsum(dO·O) (B, S, H) in f32, outside the kernels as in JAX (:445)."""
    return (g.float() * out.float()).sum(-1)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_bias, causal, scale, q_offset):
        out, lse = flash_attention_fwd(q, k, v, kv_bias, causal, scale, q_offset)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = _delta(out, g)
        dq = flash_bwd_dq(q, k, v, kv_bias, g, lse, delta, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, kv_bias, g, lse, delta, *ctx.args)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


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
    whose keys are all masked (left padding) are finite garbage, as in JAX.
    Differentiable in q, k and v through B1/B2."""
    return _FlashAttention.apply(q, k, v, kv_bias, causal, scale, q_offset)


# ---------------------------------------------------------------------------
# S1, S2: shared-prefix attention


def _pick_block(size: int, candidates: tuple) -> int:
    for c in candidates:
        if size % c == 0:
            return c
    return 128


_K_BLOCKS = (896, 768, 640, 512, 384, 256, 128)


def _sp_blocks(sc: int, lp: int, block_q: int, block_k: int) -> None:
    """The shape checks of the JAX package's `_sp_blocks` / `_sp_own_block`
    (:532-562): Sc and Lp must divide the (auto-selected) blocks. The kernels
    tile by 64 and mask ragged edges themselves; the checks keep the same
    contract on both sides."""
    block_q = block_q or _pick_block(sc, (256, 128))
    block_k = block_k or _pick_block(lp, _K_BLOCKS)
    if sc % block_q != 0 or lp % block_k != 0:
        raise ValueError(
            f"shared-prefix shapes must divide their blocks: Sc={sc} % block_q={block_q}, "
            f"Lp={lp} % block_k={block_k}"
        )
    if sc > block_k and not any(c <= block_k and sc % c == 0 for c in _K_BLOCKS):
        raise ValueError(f"no own-chunk k-block ≤ {block_k} divides Sc={sc}")


def _prefix_scores(q, kp, prefix_bias, scale):
    """Scores (B, Hkv, G, Sc, Lp) f32 of row b's scaled q against the prefix of
    prompt b // R, plus the prompt's bias."""
    B, Sc, H, D = q.shape
    P, _, Hkv, _ = kp.shape
    R = B // P
    qg = q.float().reshape(B, Sc, Hkv, H // Hkv, D) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kp.float().repeat_interleave(R, dim=0))
    return s + prefix_bias.float().repeat_interleave(R, dim=0)[:, None, None, None, :]


def _own_scores(q, ko, scale):
    """Causally masked scores (B, Hkv, G, Sc, Sc) f32 of the own chunk."""
    zero = torch.zeros(ko.shape[:2], dtype=torch.float32, device=q.device)
    return _masked_scores(q, ko, zero, True, scale, 0)


def shared_prefix_plain(q, kp, vp, ko, vo, prefix_bias, scale=None):
    """(out (B, Sc, H, D) in q's dtype, lse (B, H, Sc) f32): row b attends
    [prefix b // R with its bias | its own causal chunk], one softmax, f32."""
    B, Sc, H, D = q.shape
    R = B // kp.shape[0]
    scale = _scale(q, scale)
    sp, so = _prefix_scores(q, kp, prefix_bias, scale), _own_scores(q, ko, scale)
    m = torch.maximum(sp.amax(-1, keepdim=True), so.amax(-1, keepdim=True))
    pp, po = torch.exp(sp - m), torch.exp(so - m)
    l_safe = (pp.sum(-1, keepdim=True) + po.sum(-1, keepdim=True)).clamp_min(1e-30)
    out = (torch.einsum("bhgqk,bkhd->bqhgd", pp / l_safe, vp.float().repeat_interleave(R, dim=0))
           + torch.einsum("bhgqk,bkhd->bqhgd", po / l_safe, vo.float()))
    lse = (m + torch.log(l_safe)).reshape(B, H, Sc)
    return out.reshape(B, Sc, H, D).to(q.dtype), lse


def shared_prefix_bwd_dq_plain(q, kp, vp, ko, vo, prefix_bias, do, lse, delta, scale=None):
    """S2's dq over both sources given the global lse/delta, in q's dtype."""
    B, Sc, H, D = q.shape
    R = B // kp.shape[0]
    scale = _scale(q, scale)
    _, ds_p = _p_ds(_prefix_scores(q, kp, prefix_bias, scale), vp.repeat_interleave(R, dim=0), do, lse, delta)
    _, ds_o = _p_ds(_own_scores(q, ko, scale), vo, do, lse, delta)
    dq = (torch.einsum("bhgqk,bkhd->bqhgd", ds_p, kp.float().repeat_interleave(R, dim=0))
          + torch.einsum("bhgqk,bkhd->bqhgd", ds_o, ko.float())) * scale
    return dq.reshape(B, Sc, H, D).to(q.dtype)


def shared_prefix_bwd_dkv_plain(q, kp, vp, prefix_bias, do, lse, delta, scale=None):
    """S2's prefix (dk, dv) (P, Lp, Hkv, D) f32, summed over the R rows of
    each prompt and the G q-heads of each kv head."""
    B, Sc, H, D = q.shape
    P, Lp, Hkv, _ = kp.shape
    R = B // P
    scale = _scale(q, scale)
    p, ds = _p_ds(_prefix_scores(q, kp, prefix_bias, scale), vp.repeat_interleave(R, dim=0), do, lse, delta)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do.float().reshape(B, Sc, Hkv, H // Hkv, D))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(B, Sc, Hkv, H // Hkv, D) * scale)
    return dk.reshape(P, R, Lp, Hkv, D).sum(1), dv.reshape(P, R, Lp, Hkv, D).sum(1)


def _check_sp(name, q, kp, vp, ko, vo, prefix_bias, do=None):
    """Checks of the S1/S2 operands (`do`: the backward's dout, checked apart
    by `_check_grads_in`); ko/vo are None for the prefix dK/dV kernel. bf16
    operands (the tensor-core kernels) must also start on 16 bytes, as their
    16-byte copies do."""
    B, Sc, H, D = q.shape
    P, Lp, Hkv, _ = kp.shape
    own = () if ko is None else (ko, vo)
    kernels.require(q.dtype in kernels.DTYPE_CODE, name, f"dtype {q.dtype}")
    kernels.require(all(t.dtype == q.dtype for t in (kp, vp, *own)), name, "q/k/v dtypes differ")
    kernels.require(prefix_bias.dtype == torch.float32, name, "prefix_bias must be float32")
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in (q, kp, vp, *own, prefix_bias)),
                    name, "operands must be contiguous CUDA tensors")
    kernels.require(P > 0 and B % P == 0, name, f"B={B} rows for P={P} prompts")
    kernels.require(kp.shape == (P, Lp, Hkv, D) and vp.shape == kp.shape, name, "prefix k/v shape")
    kernels.require(all(t.shape == (B, Sc, Hkv, D) for t in own), name, "own k/v shape")
    kernels.require(prefix_bias.shape == (P, Lp), name, "prefix_bias shape")
    kernels.require(H % Hkv == 0 and D in BWD_HEAD_DIMS, name, f"H={H} Hkv={Hkv} D={D}")
    kernels.require(B <= 65535 and H <= 65535, name, "grid too large")
    kernels.require(Sc > 0 and Lp > 0, name, "empty query or prefix range")
    if q.dtype == torch.bfloat16:
        copied = (q, kp, vp, *own) + (() if do is None else (do,))
        kernels.require(all(t.data_ptr() % 16 == 0 for t in copied), name, "bf16 operands must be 16-byte aligned")


_SP_FWD_ARGS = [_P] * 8 + [_I] * 7 + [_F, _P]
_SP_DQ_ARGS = [_P] * 10 + [_I] * 7 + [_F, _P]
_SP_DKV_ARGS = [_P] * 9 + [_I] * 7 + [_F, _P]
_SP_DKV_TC_ARGS = [_P] * 11 + [_I] * 8 + [_F, _P]


def shared_prefix_fwd(q, kp, vp, ko, vo, prefix_bias, scale=None):
    """S1: (out, lse). CUDA tensors launch the kernel; CPU tensors run the plain version."""
    scale = _scale(q, scale)
    if not q.is_cuda:
        return shared_prefix_plain(q, kp, vp, ko, vo, prefix_bias, scale)
    name = "shared_prefix_fwd"
    _check_sp(name, q, kp, vp, ko, vo, prefix_bias)
    B, Sc, H, D = q.shape
    P, Lp, Hkv, _ = kp.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sc), dtype=torch.float32, device=q.device)
    tc = q.dtype == torch.bfloat16
    _launch(name, "t1_sp_fwd_tc" if tc else "t1_sp_fwd", "shared_prefix_attention", _SP_FWD_ARGS,
            [kernels.ptr(t) for t in (q, kp, vp, ko, vo, prefix_bias, out, lse)]
            + [B, P, Sc, Lp, H, Hkv, D, scale, kernels.stream(q)])
    shared_prefix_fwd.launches += 1
    shared_prefix_fwd.tc_launches += int(tc)
    return out, lse


shared_prefix_fwd.launches = 0
shared_prefix_fwd.tc_launches = 0


def shared_prefix_bwd_dq(q, kp, vp, ko, vo, prefix_bias, do, lse, delta, scale=None):
    """S2 (:739): dq over the prefix and the own chunk. delta is (B, Sc, H) f32."""
    if not q.is_cuda:
        return shared_prefix_bwd_dq_plain(q, kp, vp, ko, vo, prefix_bias, do, lse, delta, scale)
    name = "shared_prefix_bwd_dq"
    scale = _scale(q, scale)
    delta_t = delta.transpose(1, 2).contiguous()
    _check_sp(name, q, kp, vp, ko, vo, prefix_bias, do)
    _check_grads_in(name, q, do, lse, delta_t)
    B, Sc, H, D = q.shape
    P, Lp, Hkv, _ = kp.shape
    dq = torch.empty_like(q)
    tc = q.dtype == torch.bfloat16
    _launch(name, "t1_sp_bwd_dq_tc" if tc else "t1_sp_bwd_dq", "shared_prefix_attention", _SP_DQ_ARGS,
            [kernels.ptr(t) for t in (q, kp, vp, ko, vo, prefix_bias, do, lse, delta_t, dq)]
            + [B, P, Sc, Lp, H, Hkv, D, scale, kernels.stream(q)])
    shared_prefix_bwd_dq.launches += 1
    shared_prefix_bwd_dq.tc_launches += int(tc)
    return dq


shared_prefix_bwd_dq.launches = 0
shared_prefix_bwd_dq.tc_launches = 0


def shared_prefix_bwd_dkv(q, kp, vp, prefix_bias, do, lse, delta, scale=None):
    """S2 (:769): the prefix (dk, dv) (P, Lp, Hkv, D) f32, summed over the R
    rows and the G q-heads inside the kernel. delta is (B, Sc, H) f32. In bf16
    the R·G (row, q head) pairs are split over `bwd_dkv_split` blocks whose
    f32 partials one more kernel folds in a fixed order; in f32 one block
    sums them."""
    if not q.is_cuda:
        return shared_prefix_bwd_dkv_plain(q, kp, vp, prefix_bias, do, lse, delta, scale)
    name = "shared_prefix_bwd_dkv"
    scale = _scale(q, scale)
    delta_t = delta.transpose(1, 2).contiguous()
    B, Sc, H, D = q.shape
    P, Lp, Hkv, _ = kp.shape
    _check_sp(name, q, kp, vp, None, None, prefix_bias, do)
    _check_grads_in(name, q, do, lse, delta_t)
    dk = torch.empty(kp.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(kp.shape, dtype=torch.float32, device=q.device)
    ptrs = [kernels.ptr(t) for t in (q, kp, vp, prefix_bias, do, lse, delta_t, dk, dv)]
    tail = [B, P, Sc, Lp, H, Hkv, D, scale, kernels.stream(q)]
    if q.dtype == torch.bfloat16:
        n_split = bwd_dkv_split(H // Hkv, Lp, Hkv, P, B // P)
        part_ptrs = [_P(), _P()]  # n_split == 1: the blocks write dk, dv themselves
        if n_split > 1:  # freed when this call returns: they live only inside one layer's backward
            parts = torch.empty((2, n_split, *kp.shape), dtype=torch.float32, device=q.device)
            part_ptrs = [kernels.ptr(parts[0]), kernels.ptr(parts[1])]
        _launch(name, "t1_sp_bwd_dkv_prefix_tc", "shared_prefix_attention", _SP_DKV_TC_ARGS,
                ptrs + part_ptrs + [n_split] + tail)
        shared_prefix_bwd_dkv.tc_launches += 1
    else:
        _launch(name, "t1_sp_bwd_dkv_prefix", "shared_prefix_attention", _SP_DKV_ARGS, ptrs + tail)
    shared_prefix_bwd_dkv.launches += 1
    return dk, dv


shared_prefix_bwd_dkv.launches = 0
shared_prefix_bwd_dkv.tc_launches = 0


class _SharedPrefixAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kp, vp, ko, vo, prefix_bias, scale):
        out, lse = shared_prefix_fwd(q, kp, vp, ko, vo, prefix_bias, scale)
        ctx.save_for_backward(q, kp, vp, ko, vo, prefix_bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, kp, vp, ko, vo, prefix_bias, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = _delta(out, g)
        dq = shared_prefix_bwd_dq(q, kp, vp, ko, vo, prefix_bias, g, lse, delta, ctx.scale)
        # own chunk: plain causal self-attention given the GLOBAL lse/delta (B2, zero bias)
        zero_bias = torch.zeros(ko.shape[:2], dtype=torch.float32, device=q.device)
        dko, dvo = flash_bwd_dkv(q, ko, vo, zero_bias, g, lse, delta, True, ctx.scale, 0)
        dkp, dvp = shared_prefix_bwd_dkv(q, kp, vp, prefix_bias, g, lse, delta, ctx.scale)
        return (dq, dkp.to(kp.dtype), dvp.to(vp.dtype), dko.to(ko.dtype), dvo.to(vo.dtype),
                None, None)


def flash_attention_shared_prefix(
    q: torch.Tensor,  # (B, Sc, H, D), B = P·R rows, row-major by prompt
    kp: torch.Tensor,  # (P, Lp, Hkv, D) shared prompt prefixes
    vp: torch.Tensor,
    ko: torch.Tensor,  # (B, Sc, Hkv, D) own chunk keys (causal within)
    vo: torch.Tensor,
    prefix_bias: torch.Tensor,  # (P, Lp) f32 additive (0 / NEG_INF pad)
    scale: Optional[float] = None,
    block_q: int = 0,
    block_k: int = 0,
) -> torch.Tensor:
    """Row b attends [prefix_bias-masked prefix b // R | own causal chunk].
    Raises ValueError where the JAX package's `_sp_blocks` does. The backward
    sums each prompt's prefix gradient over its R rows inside S2's kernel."""
    _sp_blocks(q.shape[1], kp.shape[1], block_q, block_k)
    return _SharedPrefixAttention.apply(q, kp, vp, ko, vo, prefix_bias, _scale(q, scale))
