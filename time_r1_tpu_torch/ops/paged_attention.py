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
its `.launches`: bf16 q the tensor-core kernel (one launch, also counted in
`.tc_launches`), f32 q the exact FMA split pass and its fold (two launches,
one count). Given CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

NEG_INF = -1e30
CH = 64  # csrc/paged_attention.cu: keys per split block (f32), per tile (bf16)
HEAD_DIMS = (64, 128)  # head dims instantiated in csrc/paged_attention.cu
TC_MAX_ROWS = 16  # csrc/paged_attention.cu: the G query rows of a kv head fill one m16 tile
TC_MAX_TILES = 4  # csrc/paged_attention.cu: PG_WARPS, one 64-key tile a warp
SMEM_LIMIT = 232448  # dynamic shared memory of one H100 block, in bytes
TC_FOLD_BYTES = 64 * 1024  # csrc/paged_attention.cu: PG_FOLD_BYTES, the fold's buffer of partials

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _Params(ctypes.Structure):
    """csrc/paged_attention.cu::PagedParams, field for field."""

    _fields_ = [(n, _P) for n in (
        "q", "kp", "vp", "ks", "vs", "table", "lengths", "acc_part", "m_part", "l_part", "acc", "m", "l",
    )] + [(n, _L) for n in ("kv_sh", "kv_sp", "kv_st", "s_sh", "s_sp", "s_st")] + [
        (n, _I) for n in ("S", "Hkv", "G", "P", "max_pages", "nchunk")
    ] + [("scale", ctypes.c_float), ("ticket", _P), ("ctiles", _I)]


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


def tc_chunk_tiles(view_len: int) -> int:
    """64-key tiles per chunk (block) of the tensor-core P1/P2
    (csrc/paged_attention.cu), from the table's view of max_pages·P keys:
    enough that a slot has at most TC_FOLD_CHUNKS chunks for its last block
    to fold, at most TC_MAX_TILES (the block's warps take 16 rows of each
    tile, one tile after another). A chunk's f32 partials (G·hd·4 bytes, G
    <= 16) are then at most half the K/V they summarise (tiles·64·hd·2·c
    bytes, c = 1 for int8, 2 for bf16) at any chunk length, so G and the
    pages' dtype do not move the rule."""
    ntiles = -(-view_len // CH)
    return min(TC_MAX_TILES, max(1, -(-ntiles // TC_FOLD_CHUNKS)))


TC_FOLD_CHUNKS = 32  # the chunks a slot's last block folds, at most, where TC_MAX_TILES allows


def tc_blocks(length: int, view_len: int, ctiles: int) -> list[list[tuple[int, int]]]:
    """The tensor-core kernel's partition of one (slot, kv head), in Python:
    the length is clamped to [0, view_len] (`slot_length`); chunk x holds
    keys [x·ctiles·64, (x + 1)·ctiles·64) and is live when it starts below
    the length. Per live chunk, in order, the key ranges of its warps' tiles
    that hold a live key, each cut at the length. An empty slot has none
    (its block 0 writes the empty state); a slot with one live chunk writes
    its result from that block, with more the block that draws the last of
    len(result) tickets folds them."""
    n = min(max(length, 0), view_len)
    chunk = ctiles * CH
    return [[(k0, min(k0 + CH, n)) for k0 in range(c0, min(c0 + chunk, n), CH)] for c0 in range(0, n, chunk)]


_tc_state: dict = {}  # per device: the tickets (zero between launches) and the partials' workspace


def _tc_buffers(dev: torch.device, n_tickets: int, n_floats: int):
    """The tensor-core kernel's (S·Hkv) int32 tickets, zero between
    launches, and a float32 workspace for the chunks' partials, grown as
    needed and reused by every launch on the device (the launches are
    stream-ordered)."""
    tickets, work = _tc_state.get(dev, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 64), dtype=torch.int32, device=dev)
    if work is None or work.numel() < n_floats:
        work = torch.empty(n_floats, dtype=torch.float32, device=dev)
    _tc_state[dev] = (tickets, work)
    return tickets, work


def _outputs(S: int, nkv: int, G: int, hd: int, dev: torch.device):
    """acc (S, nkv, G, hd), m and l (S, nkv, G), float32, as views of one allocation."""
    n = S * nkv * G
    out = torch.empty(n * (hd + 2), dtype=torch.float32, device=dev)
    acc, m, l = out.split([n * hd, n, n])
    return acc.view(S, nkv, G, hd), m.view(S, nkv, G), l.view(S, nkv, G)


def _check(name: str, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int) -> bool:
    """Check the operands of either route; True for int8 pages (P2)."""
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
    kernels.require(1 <= S <= 65535 and nkv <= 65535, name, "grid too large")
    return quant


def _params(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int, outputs) -> _Params:
    """The launch arguments of either route; the partials are not set."""
    S, nkv, G, hd = q.shape
    prm = _Params()
    prm.q, prm.kp, prm.vp = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    prm.table, prm.lengths = page_table.data_ptr(), lengths.data_ptr()
    prm.acc, prm.m, prm.l = (t.data_ptr() for t in outputs)
    prm.kv_sh, prm.kv_sp, prm.kv_st = k_pages.stride(0), k_pages.stride(1), k_pages.stride(2)
    if k_scale is not None:
        prm.ks, prm.vs = k_scale.data_ptr(), v_scale.data_ptr()
        prm.s_sh, prm.s_sp, prm.s_st = k_scale.stride()
    prm.S, prm.Hkv, prm.G, prm.P, prm.max_pages = S, nkv, G, page_size, page_table.shape[1]
    prm.scale = hd**-0.5
    return prm


def _launch_fma(name: str, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int):
    """The f32 route on checked operands: the split pass and its fold; (acc, m, l)."""
    S, nkv, G, hd = q.shape
    nchunk = -(-page_table.shape[1] * page_size // CH)
    kernels.require(nchunk <= 2**31 - 1, name, "grid too large")
    dev = q.device
    acc_part = torch.empty((S, nkv, nchunk, G, hd), dtype=torch.float32, device=dev)
    m_part = torch.empty((S, nkv, nchunk, G), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    out = _outputs(S, nkv, G, hd, dev)
    prm = _params(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size, out)
    prm.acc_part, prm.m_part, prm.l_part = acc_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr()
    prm.nchunk = nchunk
    split = kernels.bind("paged_attention", "t1_paged_split", [_I, _I, ctypes.c_void_p, _P])
    kernels.check(split(int(k_scale is not None), hd, ctypes.addressof(prm), kernels.stream(q)), name)
    fold = kernels.bind("paged_attention", "t1_paged_fold", [_I, ctypes.c_void_p, _P])
    kernels.check(fold(hd, ctypes.addressof(prm), kernels.stream(q)), name)
    del acc_part, m_part, l_part  # the caching allocator reuses them only after the stream's queued work
    return out


def tc_params(name: str, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int,
              ctiles: int) -> tuple[_Params, tuple]:
    """The tensor-core kernel's launch arguments on checked bf16 operands,
    `ctiles` 64-key tiles a chunk, and its (acc, m, l), not yet written.
    The partials and tickets live in the device's workspace."""
    S, nkv, G, hd = q.shape
    elem = k_pages.element_size()
    kernels.require(G <= TC_MAX_ROWS, name, f"G = {G} query heads per kv head (at most {TC_MAX_ROWS})")
    # 16-byte copies: the pages' base and every key row on 16 bytes; q read 4 bytes at a time
    kernels.require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0 and q.data_ptr() % 4 == 0
                    and all(k_pages.stride(i) * elem % 16 == 0 for i in range(3)), name,
                    "pages and their rows must be 16-byte aligned")
    nchunk = -(-page_table.shape[1] * page_size // (CH * ctiles))
    kernels.require(1 <= ctiles <= TC_MAX_TILES and nchunk <= 2**31 - 1
                    and 128 + 2 * nchunk * TC_MAX_ROWS * 4 + TC_FOLD_BYTES <= SMEM_LIMIT, name,
                    "grid too large")  # the fold's m, l and buffer in shared memory
    dev = q.device
    tickets, work = _tc_buffers(dev, S * nkv, S * nkv * nchunk * G * (hd + 2))
    out = _outputs(S, nkv, G, hd, dev)
    prm = _params(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size, out)
    n_acc = S * nkv * nchunk * G * hd
    prm.acc_part = work.data_ptr()
    prm.m_part = prm.acc_part + 4 * n_acc
    prm.l_part = prm.m_part + 4 * S * nkv * nchunk * G
    prm.ticket, prm.nchunk, prm.ctiles = tickets.data_ptr(), nchunk, ctiles
    return prm, out


def launch_tc(name: str, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int, ctiles: int):
    """The tensor-core kernel on checked bf16 operands, `ctiles` 64-key tiles
    a chunk: one launch; (acc, m, l)."""
    prm, out = tc_params(name, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size, ctiles)
    fn = kernels.bind("paged_attention", "t1_paged_tc", [_I, _I, ctypes.c_void_p, _P])
    kernels.check(fn(int(k_scale is not None), q.shape[-1], ctypes.addressof(prm), kernels.stream(q)), name)
    return out


def _launch(name: str, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int):
    """Check the operands and launch the route of q's dtype; ((acc, m, l),
    whether it was the tensor-core kernel)."""
    quant = _check(name, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size)
    if q.dtype == torch.bfloat16:
        ct = tc_chunk_tiles(page_table.shape[1] * page_size)
        return launch_tc(name, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size, ct), True
    return _launch_fma(name, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size), False


def paged_prefix_attention(q, k_pages, v_pages, page_table, lengths, page_size: int):
    """P1: (acc, m, l) over each slot's pages. CUDA tensors launch a kernel:
    bf16 the tensor-core one (also counted in `.tc_launches`), f32 the split
    pass and its fold. CPU tensors run the plain version."""
    if not q.is_cuda:
        return paged_prefix_attention_plain(q, k_pages, v_pages, page_table, lengths, page_size)
    out, tc = _launch("paged_prefix_attention", q, k_pages, v_pages, None, None, page_table, lengths, page_size)
    paged_prefix_attention.launches += 1
    paged_prefix_attention.tc_launches += tc
    return out


paged_prefix_attention.launches = 0
paged_prefix_attention.tc_launches = 0


def paged_prefix_attention_q8(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size: int):
    """P2: P1 over int8 pages and their scales. CUDA tensors launch a kernel
    (bf16 q the tensor-core one, also counted in `.tc_launches`); CPU tensors
    run the plain version."""
    if not q.is_cuda:
        return paged_prefix_attention_q8_plain(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, page_size)
    out, tc = _launch("paged_prefix_attention_q8", q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                      page_size)
    paged_prefix_attention_q8.launches += 1
    paged_prefix_attention_q8.tc_launches += tc
    return out


paged_prefix_attention_q8.launches = 0
paged_prefix_attention_q8.tc_launches = 0
