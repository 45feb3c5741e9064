"""P1 and P2, the paged decode step's attention: the wrappers of
`csrc/paged_attention.cu`, their plain versions, and `combine_with_new_token`.

- P1 `paged_prefix_attention` replaces the Pallas kernel of the same name in
  `time_r1_tpu/ops/paged_attention.py` (pallas_call at :163): one query token
  per slot attends over its cache prefix [0, lengths[s]), read in place from
  the slot's pages through the page table, returning the unnormalised
  online-softmax state (acc, m, l).
- P2 `paged_prefix_attention_q8` replaces `paged_prefix_attention_q8` (:311):
  P1 over int8 pages with per-(token, head) f32 K/V scales, folded on the
  score axis (K) and the probability axis (V); `l` sums the unscaled
  probabilities.

The functions keep the JAX package's layout: q (S, nkv, G, hd) grouped and
post-rope; pages (nkv, n_pages, P, hd) in q's dtype or int8, read through
their strides (the paged pool's per-layer slice `pool.k[li]` is a view);
scales (nkv, n_pages, P) f32; `page_table` (S, max_pages) and `lengths` (S,)
int32 on q's device. Results: acc (S, nkv, G, hd) f32, m and l (S, nkv, G)
f32; an empty prefix gives m = -1e30, l = 0, acc = 0. The kernels read the
page table and the lengths from device memory, so a decode segment never
brings them to the host; a length past the table's max_pages·P keys is taken
as max_pages·P, as the plain version's view of the table does.

Given CUDA tensors a wrapper launches its kernel (or raises) and adds one to
its `.launches`; given CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

NEG_INF = -1e30
CH = 64  # csrc/paged_attention.cu: keys per split block
HEAD_DIMS = (64, 128)  # head dims instantiated in csrc/paged_attention.cu

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _Params(ctypes.Structure):
    """csrc/paged_attention.cu::PagedParams, field for field."""

    _fields_ = [(n, _P) for n in (
        "q", "kp", "vp", "ks", "vs", "table", "lengths", "acc_part", "m_part", "l_part", "acc", "m", "l",
    )] + [(n, _L) for n in ("kv_sh", "kv_sp", "kv_st", "s_sh", "s_sp", "s_st")] + [
        (n, _I) for n in ("S", "Hkv", "G", "P", "max_pages", "nchunk")
    ] + [("scale", ctypes.c_float)]


# ---------------------------------------------------------------------------
# plain versions


def paged_prefix_attention_plain(q, k_pages, v_pages, page_table, lengths, page_size: int):
    """The gather-view oracle (`time_r1_tpu/ops/paged_attention.py:329`): the
    contiguous (nkv, S, max_pages·P, hd) view of every slot's pages is built,
    scored in f32 and masked at pos >= lengths[s]; masked keys get
    probability 0, so an empty prefix gives m = NEG_INF, l = 0, acc = 0."""
    S, nkv, G, hd = q.shape
    max_pages = page_table.shape[1]
    view_len = max_pages * page_size
    idx = page_table.long()
    k_view = k_pages[:, idx].reshape(nkv, S, view_len, hd)
    v_view = v_pages[:, idx].reshape(nkv, S, view_len, hd)
    sc = torch.einsum("shgd,hskd->shgk", q.float(), k_view.float()) * hd**-0.5
    valid = torch.arange(view_len, device=q.device)[None, None, None, :] < lengths.long()[:, None, None, None]
    sc = torch.where(valid, sc, NEG_INF)
    m = sc.amax(-1)
    p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
    return torch.einsum("shgk,hskd->shgd", p, v_view.float()), m, p.sum(-1)


def paged_prefix_attention_q8_plain(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int):
    """Dequantize the int8 pages, then the gather-view oracle
    (`time_r1_tpu/ops/paged_attention.py:317`)."""
    kd = k_pages.float() * k_scale.float()[..., None]
    vd = v_pages.float() * v_scale.float()[..., None]
    return paged_prefix_attention_plain(q, kd, vd, page_table, lengths, page_size)


def combine_with_new_token(acc, m, l, q, k_new, v_new) -> torch.Tensor:
    """Fold the current token into the prefix state: out[s, h, g] =
    softmax([prefix scores, q·k_new]) @ [V_prefix, v_new]
    (`time_r1_tpu/ops/paged_attention.py:352`). q (S, nkv, G, hd), k_new and
    v_new (S, nkv, hd); returns (S, nkv, G, hd) f32. An empty prefix
    (m = NEG_INF, l = 0) reduces to out = v_new. Plain torch, as in JAX."""
    scale = q.shape[-1] ** -0.5
    s_new = torch.einsum("shgd,shd->shg", q.float(), k_new.float()) * scale
    m_tot = torch.maximum(m, s_new)
    a = torch.exp(m - m_tot)  # prefix correction
    b = torch.exp(s_new - m_tot)  # new-token weight
    num = acc * a[..., None] + b[..., None] * v_new.float()[:, :, None, :]
    return num / (l * a + b)[..., None]


# ---------------------------------------------------------------------------
# kernels


def _launch(name: str, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int):
    """Check the operands, launch the split pass and its fold; (acc, m, l)."""
    quant = k_scale is not None
    S, nkv, G, hd = q.shape
    max_pages = page_table.shape[1] if page_table.dim() == 2 else -1
    kernels.require(q.dtype in kernels.DTYPE_CODE and q.is_contiguous(), name, "q must be contiguous f32 or bf16")
    kernels.require(hd in HEAD_DIMS, name, f"head dim {hd}")
    kernels.require(k_pages.dtype == (torch.int8 if quant else q.dtype) and v_pages.dtype == k_pages.dtype, name,
                    "pages must have q's dtype (P1) or be int8 (P2)")
    kernels.require(k_pages.dim() == 4 and k_pages.shape[0] == nkv and k_pages.shape[2:] == (page_size, hd)
                    and v_pages.shape == k_pages.shape and v_pages.stride() == k_pages.stride()
                    and k_pages.stride(-1) == 1, name,
                    "pages must be (nkv, n_pages, P, hd) with equal strides and a contiguous last axis")
    if quant:
        kernels.require(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32
                        and k_scale.shape == k_pages.shape[:3] and v_scale.shape == k_scale.shape
                        and v_scale.stride() == k_scale.stride(), name,
                        "scales must be (nkv, n_pages, P) float32 with equal strides")
    kernels.require(page_table.dtype == torch.int32 and max_pages >= 1 and page_table.shape[0] == S
                    and page_table.is_contiguous(), name, "page_table must be (S, max_pages) contiguous int32")
    kernels.require(lengths.dtype == torch.int32 and lengths.shape == (S,) and lengths.is_contiguous(), name,
                    "lengths must be (S,) contiguous int32")
    tensors = [q, k_pages, v_pages, page_table, lengths] + ([k_scale, v_scale] if quant else [])
    kernels.require(all(t.is_cuda and t.device == q.device for t in tensors), name,
                    "operands must be CUDA tensors on one device")
    nchunk = -(-max_pages * page_size // CH)
    kernels.require(1 <= S <= 65535 and nkv <= 65535 and nchunk <= 2**31 - 1, name, "grid too large")
    dev = q.device
    acc_part = torch.empty((S, nkv, nchunk, G, hd), dtype=torch.float32, device=dev)
    m_part = torch.empty((S, nkv, nchunk, G), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc = torch.empty((S, nkv, G, hd), dtype=torch.float32, device=dev)
    m = torch.empty((S, nkv, G), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    prm = _Params()
    prm.q, prm.kp, prm.vp = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    prm.table, prm.lengths = page_table.data_ptr(), lengths.data_ptr()
    prm.acc_part, prm.m_part, prm.l_part = acc_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr()
    prm.acc, prm.m, prm.l = acc.data_ptr(), m.data_ptr(), l.data_ptr()
    prm.kv_sh, prm.kv_sp, prm.kv_st = k_pages.stride(0), k_pages.stride(1), k_pages.stride(2)
    if quant:
        prm.ks, prm.vs = k_scale.data_ptr(), v_scale.data_ptr()
        prm.s_sh, prm.s_sp, prm.s_st = k_scale.stride()
    prm.S, prm.Hkv, prm.G, prm.P, prm.max_pages, prm.nchunk = S, nkv, G, page_size, max_pages, nchunk
    prm.scale = hd**-0.5
    split = kernels.bind("paged_attention", "t1_paged_split", [_I, _I, _I, ctypes.c_void_p, _P])
    kernels.check(split(kernels.DTYPE_CODE[q.dtype], int(quant), hd, ctypes.addressof(prm), kernels.stream(q)), name)
    fold = kernels.bind("paged_attention", "t1_paged_fold", [_I, ctypes.c_void_p, _P])
    kernels.check(fold(hd, ctypes.addressof(prm), kernels.stream(q)), name)
    del acc_part, m_part, l_part  # the caching allocator reuses them only after the stream's queued work
    return acc, m, l


def paged_prefix_attention(q, k_pages, v_pages, page_table, lengths, page_size: int):
    """P1: (acc, m, l) over each slot's pages. CUDA tensors launch the split
    pass and its fold; CPU tensors run the plain version."""
    if not q.is_cuda:
        return paged_prefix_attention_plain(q, k_pages, v_pages, page_table, lengths, page_size)
    out = _launch("paged_prefix_attention", q, k_pages, v_pages, None, None, page_table, lengths, page_size)
    paged_prefix_attention.launches += 1
    return out


paged_prefix_attention.launches = 0


def paged_prefix_attention_q8(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int):
    """P2: P1 over int8 pages and their scales. CUDA tensors launch the
    kernels; CPU tensors run the plain version."""
    if not q.is_cuda:
        return paged_prefix_attention_q8_plain(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size)
    out = _launch("paged_prefix_attention_q8", q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size)
    paged_prefix_attention_q8.launches += 1
    return out


paged_prefix_attention_q8.launches = 0
