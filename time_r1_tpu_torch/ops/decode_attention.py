"""D1 and D2, the shared-prefix decode step's attention: the wrappers of
`csrc/decode_attention.cu`, their plain versions, and `merge_shared_tail`.

- D1 `shared_prefix_decode_attention` replaces the Pallas kernel of the same
  name in `time_r1_tpu/ops/decode_attention.py` (pallas_call at :171): the
  online softmax of every rollout row over its prompt's shared prefix,
  returning the unnormalised (acc, m, l).
- D2 `shared_prefix_decode_full` replaces `shared_prefix_decode_full` (:403):
  the whole decode step's softmax over [prefix | own suffix | new token].

The functions keep the JAX package's head-major layouts: q (P, Hkv, N, hd)
with N = R·G grouped rows, the prefix (P, Hkv, Lp, hd), the suffix
(B, Hkv, Lo, hd), scales without hd. The caches may be strided views (the
port passes `cache.transpose(1, 2)` of its token-major caches, read in place
by the kernels). D2 takes the own suffix's live length as a host int
(`own_len`, uniform across the rows) where the JAX kernel takes the (Lo,)
validity bias it is made from.

Given CUDA tensors a wrapper launches its kernel (or raises) and adds one to
its `.launches`. D2 in bf16 (bf16 or int8 caches) is one launch of the
tensor-core kernel, which folds its prefix chunks, the row's suffix and the
new token itself, and also adds one to `.tc_launches`; D2 in f32 runs the
FMA split pass (D1's kernel, not counted as a D1 launch) and its tail
kernel. Given CPU tensors the wrappers run the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels

NEG_INF = -1e30
CH = 64  # csrc/decode_attention.cu: prefix keys per split block
HEAD_DIMS = (64, 128)  # head dims instantiated in csrc/decode_attention.cu

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _Params(ctypes.Structure):
    """csrc/decode_attention.cu::DecodeParams, field for field."""

    _fields_ = [(n, _P) for n in (
        "q", "kp", "vp", "ksp", "vsp", "bias", "ko", "vo", "kso", "vso", "kn", "vn", "o",
        "acc_part", "m_part", "l_part", "acc_out", "m_out", "l_out", "ticket",
    )] + [(n, _L) for n in (
        "kv_sp", "kv_sh", "kv_st", "s_sp", "s_sh", "s_st", "own_sb", "own_sh", "own_st",
        "os_sb", "os_sh", "os_st", "n_sb", "n_sh",
    )] + [(n, _I) for n in ("P", "Hkv", "N", "Lp", "R", "G", "nchunk", "own_len", "ctiles")] + [("scale", ctypes.c_float)]


# ---------------------------------------------------------------------------
# plain versions


def shared_prefix_decode_attention_plain(q, k_pref, v_pref, ks, vs, bias):
    """(acc (P, Hkv, N, hd) f32 unnormalised, m (P, Hkv, N), l (P, Hkv, N)).
    Keys at the mask floor get probability 0, so a fully masked prefix gives
    m = NEG_INF, l = 0, acc = 0."""
    scale = q.shape[-1] ** -0.5
    sc = torch.einsum("phnd,phkd->phnk", q.float() * scale, k_pref.float())
    if ks is not None:
        sc = sc * ks.float()[:, :, None, :]
    sc = sc + bias.float()[:, None, None, :]
    m = sc.amax(-1).clamp_min(NEG_INF)
    p = torch.where(sc > NEG_INF * 0.5, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = p.sum(-1)
    if vs is not None:
        p = p * vs.float()[:, :, None, :]
    return torch.einsum("phnk,phkd->phnd", p, v_pref.float()), m, l


def _rows(x: torch.Tensor, P: int, R: int) -> torch.Tensor:
    """(P, Hkv, R·G, ...) kernel rows → (B, Hkv, G, ...) batch rows."""
    Hkv, N = x.shape[1], x.shape[2]
    return x.reshape(P, Hkv, R, N // R, *x.shape[3:]).transpose(1, 2).reshape(P * R, Hkv, N // R, *x.shape[3:])


def _fold_tail(acc, m, l, q_rows, k_own, v_own, ks_own, vs_own, own_valid, k_new, v_new):
    """Fold a row's own suffix (head-major, keys where the (B|1, Lo) bool
    own_valid holds; k_own None for none) and its new token into the prefix
    softmax state (B, Hkv, G, ...), and normalise."""
    ln = torch.einsum("bhgd,bhd->bhg", q_rows, k_new.float())
    m_tail = ln
    if k_own is not None:
        lo = torch.einsum("bhgd,bhkd->bhgk", q_rows, k_own.float())
        if ks_own is not None:
            lo = lo * ks_own.float()[:, :, None, :]
        lo = lo + torch.where(own_valid, 0.0, NEG_INF).float()[:, None, None, :]
        m_tail = torch.maximum(lo.amax(-1), ln)
    m_tot = torch.maximum(m, m_tail)
    corr = torch.exp(m - m_tot)
    pn = torch.exp(ln - m_tot)
    num = acc * corr[..., None] + pn[..., None] * v_new.float()[:, :, None, :]
    den = l * corr + pn
    if k_own is not None:
        po = torch.where(lo > NEG_INF * 0.5, torch.exp(lo - m_tot[..., None]), torch.zeros_like(lo))
        den = den + po.sum(-1)
        if vs_own is not None:
            po = po * vs_own.float()[:, :, None, :]
        num = num + torch.einsum("bhgk,bhkd->bhgd", po, v_own.float())
    return num / den[..., None]


def shared_prefix_decode_full_plain(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own,
                                    own_len: int, k_new, v_new) -> torch.Tensor:
    """The normalised (P, Hkv, N, hd) context in q's dtype."""
    P, Hkv, N, hd = q.shape
    R = k_own.shape[0] // P
    acc, m, l = shared_prefix_decode_attention_plain(q, k_pref, v_pref, ks, vs, bias)
    q_rows = _rows(q.float(), P, R) * hd**-0.5
    own_valid = torch.arange(k_own.shape[2], device=q.device)[None] < int(own_len)
    out = _fold_tail(_rows(acc, P, R), _rows(m, P, R), _rows(l, P, R), q_rows,
                     k_own, v_own, ks_own, vs_own, own_valid, k_new, v_new)
    return out.reshape(P, R, Hkv, N // R, hd).transpose(1, 2).reshape(P, Hkv, N, hd).to(q.dtype)


def merge_shared_tail(
    acc: torch.Tensor,  # (P, Hkv, N, hd) f32 unnormalised
    m: torch.Tensor,  # (P, Hkv, N)
    l: torch.Tensor,  # (P, Hkv, N)
    q: torch.Tensor,  # (B, 1, H, hd) the same post-rope queries
    k_own: Optional[torch.Tensor],  # (B, Lo, Hkv, hd) int8|float suffix, or None
    v_own: Optional[torch.Tensor],
    ks_own: Optional[torch.Tensor],  # (B, Lo, Hkv) f32 | None
    vs_own: Optional[torch.Tensor],
    k_new: torch.Tensor,  # (B, 1, Hkv, hd) current token
    v_new: torch.Tensor,
    bias_own: Optional[torch.Tensor],  # (B|1, 1, 1, Lo) f32 | None
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fold the per-row suffix and the new token into D1's prefix softmax state
    (`time_r1_tpu/ops/decode_attention.py:419`); (B, 1, H, hd) in q's dtype.
    Plain torch, as in the JAX package."""
    B, _, H, hd = q.shape
    P, Hkv, N, _ = acc.shape
    R = B // P
    if scale is None:
        scale = hd**-0.5
    q_rows = q.float().reshape(B, Hkv, H // Hkv, hd) * scale
    own = None
    if k_own is not None:
        k_own, v_own = k_own.transpose(1, 2), v_own.transpose(1, 2)
        ks_own = None if ks_own is None else ks_own.transpose(1, 2)
        vs_own = None if vs_own is None else vs_own.transpose(1, 2)
        own = (torch.ones(1, k_own.shape[2], dtype=torch.bool, device=q.device) if bias_own is None
               else bias_own[:, 0, 0, :] > NEG_INF * 0.5)
    out = _fold_tail(_rows(acc, P, R), _rows(m, P, R), _rows(l, P, R), q_rows, k_own, v_own, ks_own, vs_own,
                     own, k_new.reshape(B, Hkv, hd), v_new.reshape(B, Hkv, hd))
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# kernels


def _check_prefix(name, q, k_pref, v_pref, ks, vs, bias) -> bool:
    """Checks shared by D1 and D2; returns whether the caches are int8."""
    P, Hkv, N, hd = q.shape
    Lp = k_pref.shape[2]
    quant = k_pref.dtype == torch.int8
    kernels.require(q.dtype in kernels.DTYPE_CODE and q.is_contiguous(), name, "q must be contiguous f32 or bf16")
    kernels.require(hd in HEAD_DIMS, name, f"head dim {hd}")
    kernels.require(k_pref.dtype in (q.dtype, torch.int8) and v_pref.dtype == k_pref.dtype, name,
                    "the prefix must have q's dtype or be int8")
    kernels.require(k_pref.shape == (P, Hkv, Lp, hd) and v_pref.shape == k_pref.shape
                    and v_pref.stride() == k_pref.stride() and k_pref.stride(-1) == 1, name,
                    "prefix K/V must be (P, Hkv, Lp, hd) with equal strides and a contiguous last axis")
    kernels.require((ks is not None) == quant and (vs is not None) == quant, name, "scales go with int8 caches")
    if quant:
        kernels.require(ks.dtype == torch.float32 and ks.shape == (P, Hkv, Lp) and vs.shape == ks.shape
                        and vs.stride() == ks.stride() and vs.dtype == torch.float32, name,
                        "prefix scales must be (P, Hkv, Lp) float32 with equal strides")
    kernels.require(bias.dtype == torch.float32 and bias.shape == (P, Lp) and bias.is_contiguous(), name,
                    "bias must be (P, Lp) contiguous float32")
    tensors = [q, k_pref, v_pref, bias] + ([ks, vs] if quant else [])
    kernels.require(all(t.is_cuda for t in tensors), name, "operands must be CUDA tensors")
    return quant


def _prefix_params(q, k_pref, v_pref, ks, vs, bias, quant: bool) -> _Params:
    """The launch arguments of the prefix operands."""
    P, Hkv, N, hd = q.shape
    prm = _Params()
    prm.q, prm.kp, prm.vp, prm.bias = q.data_ptr(), k_pref.data_ptr(), v_pref.data_ptr(), bias.data_ptr()
    prm.kv_sp, prm.kv_sh, prm.kv_st = k_pref.stride(0), k_pref.stride(1), k_pref.stride(2)
    if quant:
        prm.ksp, prm.vsp = ks.data_ptr(), vs.data_ptr()
        prm.s_sp, prm.s_sh, prm.s_st = ks.stride()
    prm.P, prm.Hkv, prm.N, prm.Lp = P, Hkv, N, k_pref.shape[2]
    prm.scale = hd**-0.5
    return prm


def _split(q, k_pref, v_pref, ks, vs, bias, quant: bool):
    """Launch the f32-FMA prefix pass (D1's, and D2's in f32): (params,
    per-chunk scratch kept alive)."""
    P, Hkv, N, hd = q.shape
    Lp = k_pref.shape[2]
    nchunk = -(-Lp // CH)
    kernels.require(nchunk <= 2**31 - 1 and Hkv <= 65535 and P <= 65535, "shared_prefix_decode_attention",
                    "grid too large")
    dev = q.device
    acc_part = torch.empty((P, Hkv, nchunk, N, hd), dtype=torch.float32, device=dev)
    m_part = torch.empty((P, Hkv, nchunk, N), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    prm = _prefix_params(q, k_pref, v_pref, ks, vs, bias, quant)
    prm.acc_part, prm.m_part, prm.l_part = acc_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr()
    prm.nchunk = nchunk
    fn = kernels.bind("decode_attention", "t1_decode_prefix_split", [_I, _I, _I, ctypes.c_void_p, _P])
    rc = fn(kernels.DTYPE_CODE[q.dtype], int(quant), hd, ctypes.addressof(prm), kernels.stream(q))
    kernels.check(rc, "shared_prefix_decode_attention")
    return prm, (acc_part, m_part, l_part)


def shared_prefix_decode_attention(q, k_pref, v_pref, ks, vs, bias):
    """D1: (acc, m, l) over the shared prefix. CUDA tensors launch the split
    pass and its fold; CPU tensors run the plain version."""
    if not q.is_cuda:
        return shared_prefix_decode_attention_plain(q, k_pref, v_pref, ks, vs, bias)
    quant = _check_prefix("shared_prefix_decode_attention", q, k_pref, v_pref, ks, vs, bias)
    P, Hkv, N, hd = q.shape
    prm, scratch = _split(q, k_pref, v_pref, ks, vs, bias, quant)
    shared_prefix_decode_attention.launches += 1
    acc = torch.empty((P, Hkv, N, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((P, Hkv, N), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    prm.acc_out, prm.m_out, prm.l_out = acc.data_ptr(), m.data_ptr(), l.data_ptr()
    fn = kernels.bind("decode_attention", "t1_decode_prefix_combine", [_I, ctypes.c_void_p, _P])
    kernels.check(fn(hd, ctypes.addressof(prm), kernels.stream(q)), "shared_prefix_decode_attention")
    del scratch  # the caching allocator reuses it only after the stream's queued work
    return acc, m, l


shared_prefix_decode_attention.launches = 0


def tc_chunk_tiles(Lp: int, N: int, int8: bool) -> int:
    """64-key tiles per prefix block of the tensor-core D2
    (csrc/decode_attention.cu): at least 4 (two a warpgroup, the suffix
    block's chain, and few slots for the one-block fold), at least enough
    that a block's f32 partials (N·hd·4 bytes) are at most half the K/V they
    summarise (tiles·64·hd·2·c bytes, c = 1 for int8, 2 for bf16), and at
    most 64 chunks (the fold's slots); never more than the prefix has."""
    ntiles = -(-Lp // 64)
    least = max(4, -(-N // (16 * (1 if int8 else 2))), -(-ntiles // TC_MAX_CHUNKS))
    return max(1, min(ntiles, least))


TC_MAX_CHUNKS = 64  # csrc/decode_attention.cu: DEC_MAX_SLOTS - 1
_tc_state: dict = {}  # per device: the tickets (zero between launches) and the partials' workspace


def _tc_buffers(dev: torch.device, n_tickets: int, n_floats: int):
    """The tensor-core D2's (P·Hkv) int32 tickets, zero between launches,
    and a float32 workspace for the partials, grown as needed and reused by
    every launch on the device (the launches are stream-ordered)."""
    tickets, work = _tc_state.get(dev, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 64), dtype=torch.int32, device=dev)
    if work is None or work.numel() < n_floats:
        work = torch.empty(n_floats, dtype=torch.float32, device=dev)
    _tc_state[dev] = (tickets, work)
    return tickets, work


def _full_params(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own, own_len, k_new, v_new, quant):
    """D2's launch arguments for both kernels; the partials are not set."""
    P, Hkv, N, hd = q.shape
    B = k_own.shape[0]
    prm = _prefix_params(q, k_pref, v_pref, ks, vs, bias, quant)
    prm.ko, prm.vo, prm.kn, prm.vn = k_own.data_ptr(), v_own.data_ptr(), k_new.data_ptr(), v_new.data_ptr()
    prm.own_sb, prm.own_sh, prm.own_st = k_own.stride(0), k_own.stride(1), k_own.stride(2)
    prm.n_sb, prm.n_sh = k_new.stride(0), k_new.stride(1)
    if quant:
        prm.kso, prm.vso = ks_own.data_ptr(), vs_own.data_ptr()
        prm.os_sb, prm.os_sh, prm.os_st = ks_own.stride()
    prm.R, prm.G, prm.own_len = B // P, N // (B // P), own_len
    return prm


def full_tc_params(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own, own_len: int, k_new, v_new,
                   ctiles: int) -> tuple[_Params, torch.Tensor]:
    """The tensor-core D2's launch arguments on checked bf16 operands,
    `ctiles` 64-key tiles per prefix block, and its output (not yet
    written). The partials live in the device's workspace."""
    P, Hkv, N, hd = q.shape
    quant = k_pref.dtype == torch.int8
    nchunk = -(-k_pref.shape[2] // (64 * ctiles))
    nslot = nchunk + 1
    tickets, work = _tc_buffers(q.device, P * Hkv, P * Hkv * nslot * N * (hd + 2))
    out = torch.empty_like(q)
    prm = _full_params(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own, own_len, k_new, v_new, quant)
    n_acc = P * Hkv * nslot * N * hd
    prm.acc_part = work.data_ptr()
    prm.m_part = prm.acc_part + 4 * n_acc
    prm.l_part = prm.m_part + 4 * P * Hkv * nslot * N
    prm.ticket, prm.o, prm.nchunk, prm.ctiles = tickets.data_ptr(), out.data_ptr(), nchunk, ctiles
    return prm, out


def launch_full_tc(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own, own_len: int, k_new, v_new,
                   ctiles: int) -> torch.Tensor:
    """The tensor-core D2 kernel on checked bf16 operands, `ctiles` 64-key
    tiles per prefix block."""
    prm, out = full_tc_params(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own, own_len, k_new, v_new,
                              ctiles)
    fn = kernels.bind("decode_attention", "t1_decode_full_tc", [_I, _I, ctypes.c_void_p, _P])
    rc = fn(int(k_pref.dtype == torch.int8), q.shape[-1], ctypes.addressof(prm), kernels.stream(q))
    kernels.check(rc, "shared_prefix_decode_full")
    return out


def shared_prefix_decode_full(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own,
                              own_len: int, k_new, v_new) -> torch.Tensor:
    """D2: the normalised (P, Hkv, N, hd) context in q's dtype. CUDA tensors
    launch a kernel: bf16 the tensor-core one (one launch; also counted in
    `.tc_launches`), f32 the FMA split pass and tail (two launches, one
    count). CPU tensors run the plain version."""
    if not q.is_cuda:
        return shared_prefix_decode_full_plain(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own,
                                               own_len, k_new, v_new)
    name = "shared_prefix_decode_full"
    quant = _check_prefix(name, q, k_pref, v_pref, ks, vs, bias)
    P, Hkv, N, hd = q.shape
    B, _, Lo, _ = k_own.shape
    R = B // P
    own_len = int(own_len)
    kernels.require(B == P * R and N % R == 0, name, f"B={B} rows over P={P} prompts, N={N}")
    kernels.require(k_own.dtype == k_pref.dtype and v_own.dtype == k_own.dtype, name,
                    "the suffix must have the prefix's dtype")
    kernels.require(k_own.shape == (B, Hkv, Lo, hd) and v_own.shape == k_own.shape
                    and v_own.stride() == k_own.stride() and k_own.stride(-1) == 1, name,
                    "suffix K/V must be (B, Hkv, Lo, hd) with equal strides and a contiguous last axis")
    kernels.require(0 <= own_len <= Lo, name, f"own_len {own_len} of {Lo}")
    kernels.require((ks_own is not None) == quant and (vs_own is not None) == quant, name,
                    "scales go with int8 caches")
    if quant:
        kernels.require(ks_own.dtype == torch.float32 and vs_own.dtype == torch.float32
                        and ks_own.shape == (B, Hkv, Lo) and vs_own.shape == ks_own.shape
                        and vs_own.stride() == ks_own.stride(), name, "suffix scales must be (B, Hkv, Lo) float32")
    kernels.require(k_new.dtype == q.dtype and v_new.dtype == q.dtype and k_new.shape == (B, Hkv, hd)
                    and v_new.shape == k_new.shape and v_new.stride() == k_new.stride() and k_new.stride(-1) == 1,
                    name, "new K/V must be (B, Hkv, hd) in q's dtype")
    tensors = [k_own, v_own, k_new, v_new] + ([ks_own, vs_own] if quant else [])
    kernels.require(all(t.is_cuda for t in tensors), name, "operands must be CUDA tensors")
    kernels.require(B <= 65535 and Hkv <= 65535, name, "grid too large")
    if q.dtype == torch.bfloat16:
        # 16-byte copies: every base and every cache row on 16 bytes
        caches = [k_pref, v_pref, k_own, v_own]
        kernels.require(all(t.data_ptr() % 16 == 0 for t in [q, k_new, v_new] + caches)
                        and all((t.stride(2) * t.element_size()) % 16 == 0 for t in caches)
                        and all((t.stride(0) * 2) % 16 == 0 and (t.stride(1) * 2) % 16 == 0 for t in (k_new, v_new)),
                        name, "operands and cache rows must be 16-byte aligned")
        kernels.require(N // R <= 64 and P <= 65535, name, f"G = {N // R} query heads per kv head (at most 64)")
        out = launch_full_tc(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own, own_len, k_new, v_new,
                             tc_chunk_tiles(k_pref.shape[2], N, quant))
        shared_prefix_decode_full.launches += 1
        shared_prefix_decode_full.tc_launches += 1
        return out
    prm, scratch = _split(q, k_pref, v_pref, ks, vs, bias, quant)
    out = torch.empty_like(q)
    full = _full_params(q, k_pref, v_pref, ks, vs, bias, k_own, v_own, ks_own, vs_own, own_len, k_new, v_new, quant)
    full.acc_part, full.m_part, full.l_part, full.nchunk = prm.acc_part, prm.m_part, prm.l_part, prm.nchunk
    full.o = out.data_ptr()
    fn = kernels.bind("decode_attention", "t1_decode_tail", [_I, _I, _I, ctypes.c_void_p, _P])
    kernels.check(fn(kernels.DTYPE_CODE[q.dtype], int(quant), hd, ctypes.addressof(full), kernels.stream(q)), name)
    shared_prefix_decode_full.launches += 1
    del scratch
    return out


shared_prefix_decode_full.launches = 0
shared_prefix_decode_full.tc_launches = 0
