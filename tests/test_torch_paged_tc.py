"""The numerics and the partition of the tensor-core P1/P2 (the paged decode
step's attention, `time_r1_tpu_torch/csrc/paged_attention.cu`), emulated in
torch on the CPU, against the JAX package's Pallas kernels in interpret mode
(products in f32):

- (a) bf16 q over bf16 pages (P1) or int8 pages (P2: converted exactly, K
  scales on S, V scales on P after `l` has summed it and before its bf16
  rounding). The chunks of the kernel's partition (`tc_blocks`) from the
  slot lengths; in each chunk warp w takes rows 16w .. 16w + 15 of every
  64-key tile with its own online softmax (S in f32 from bf16 operands, the
  scale after, keys past the length -inf, the running sum on the unrounded
  P, P rounded to bf16 before P·V); the warps merge in warp order and the
  chunks fold in chunk order, weights exp(m - max). Against
  `time_r1_tpu.ops.paged_attention.paged_prefix_attention` and `_q8` at the
  lengths of tests/test_torch_paged_attention.py's CASES, every slot at
  max_pages·P, an empty slot with a stale table row, G = 7 over 4 kv heads
  (the 7B) and G = 12 at head dim 64, at the wrapper's chunk length and at 4
  tiles a chunk: within PAGED_TOL's bf16 2e-2 of max |JAX| per output (m
  over the live slots), as `chip_smoke.py` holds the kernel to its plain
  version; an empty slot exactly (acc 0, m -1e30, l 0);
- (b) the partition: the chunk rule (`tc_chunk_tiles`), and `tc_blocks`
  covers each live key once, in order, and in any order of arrival exactly
  one block of a (slot, kv head) draws the last ticket;
- (c) on CPU tensors both wrappers run their plain versions and count no
  launch, tensor-core or other."""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from time_r1_tpu.ops import paged_attention as jpa
from time_r1_tpu.ops.quant import quantize_kv as jax_quantize_kv
from time_r1_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)

TC_TOL = 2e-2  # chip_smoke.PAGED_TOL["bfloat16"]: max |emulation - JAX| / max |JAX| per output


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _warp(q, k, v, ks, vs, w: int, tiles, scale: float):
    """Warp w's online softmax over rows 16w .. 16w + 15 of each tile (k0,
    k1) of its chunk: unnormalised (o, m, l), or None without a live key."""
    m = torch.full((q.shape[0],), pa.NEG_INF)
    l = torch.zeros(q.shape[0])
    o = torch.zeros(q.shape[0], v.shape[-1])
    live = False
    for k0, k1 in tiles:
        a, b = k0 + 16 * w, min(k0 + 16 * w + 16, k1)
        if a >= b:
            break
        live = True
        x = (q @ k[a:b].T) * scale
        if ks is not None:
            x = x * ks[a:b]
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[:, None])
        l = l * alpha + p.sum(-1)  # the unrounded f32 P
        if vs is not None:
            p = p * vs[a:b]
        o = o * alpha[:, None] + _bf16(p) @ v[a:b]
        m = m_new
    return (o, m, l) if live else None


def _fold(states):
    """Fold unnormalised (o, m, l) states in order, weights exp(m_i - m)."""
    m = torch.stack([s[1] for s in states]).amax(0)
    acc, l = torch.zeros_like(states[0][0]), torch.zeros_like(m)
    for o, mi, li in states:
        a = torch.exp(mi - m)
        acc = acc + a[:, None] * o
        l = l + a * li
    return acc, m, l


def tc_paged(q, kp, vp, ks, vs, table, lengths, P: int, ctiles: int):
    """The tensor-core P1/P2's arithmetic: q (S, nkv, G, D) bf16-valued,
    pages (nkv, n_pages, P, D) bf16-valued, or int8-valued with scales
    (nkv, n_pages, P). (acc, m, l) in f32."""
    S, nkv, G, D = q.shape
    view = table.shape[1] * P
    acc, m, l = torch.zeros(S, nkv, G, D), torch.full((S, nkv, G), pa.NEG_INF), torch.zeros(S, nkv, G)
    for s in range(S):
        keys = table[s].long().repeat_interleave(P) * P + torch.arange(P).repeat(table.shape[1])  # view -> pool row
        for h in range(nkv):
            kh, vh = kp[h].reshape(-1, D)[keys], vp[h].reshape(-1, D)[keys]
            ksh = None if ks is None else ks[h].reshape(-1)[keys]
            vsh = None if vs is None else vs[h].reshape(-1)[keys]
            chunks = []
            for tiles in pa.tc_blocks(int(lengths[s]), view, ctiles):
                warps = [_warp(q[s, h], kh, vh, ksh, vsh, w, tiles, D**-0.5) for w in range(pa.TC_MAX_TILES)]
                chunks.append(_fold([x for x in warps if x is not None]))
            if chunks:
                acc[s, h], m[s, h], l[s, h] = chunks[0] if len(chunks) == 1 else _fold(chunks)
    return acc, m, l


def _case(seed, lengths, P, nkv=2, G=8, D=128, max_pages=None, stale_from=None):
    """q, bf16-valued pages, their int8 pages and scales (JAX's quantize_kv),
    a page table over a pool whose page 0 is scratch, and the lengths."""
    rng = np.random.default_rng(seed)
    S = len(lengths)
    need = [-(-n // P) for n in lengths]
    max_pages = max_pages or max(3, max(need))
    n_pages = 1 + sum(need) + 4
    f = functools.partial(rng.normal, size=(nkv, n_pages, P, D))
    kp, vp = (_bf16(torch.from_numpy(f().astype(np.float32))).numpy() for _ in range(2))
    q = _bf16(torch.from_numpy(rng.normal(size=(S, nkv, G, D)).astype(np.float32))).numpy()
    table = np.zeros((S, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for s, n in enumerate(need):
        for j in range(n):
            table[s, j] = free.pop()
    if stale_from is not None:
        table[0] = table[stale_from]
    k8, ks = (np.asarray(x) for x in jax_quantize_kv(jnp.asarray(kp)))
    v8, vs = (np.asarray(x) for x in jax_quantize_kv(jnp.asarray(vp)))
    return dict(q=q, kp=kp, vp=vp, k8=k8, v8=v8, ks=ks, vs=vs, table=table, lengths=np.array(lengths, np.int32), P=P)


CASES = {
    "(0, 100, 300) P 128": dict(seed=0, lengths=(0, 100, 300), P=128),
    "(128, 256, 37) P 128": dict(seed=1, lengths=(128, 256, 37), P=128),
    "(0, 37, 300) P 16": dict(seed=2, lengths=(0, 37, 300), P=16),
    "every slot full": dict(seed=3, lengths=(512, 512), P=128, max_pages=4),
    "empty slot, stale row": dict(seed=4, lengths=(0, 100, 300), P=128, stale_from=2),
    "7B: G 7 over 4 kv heads": dict(seed=5, lengths=(70, 0, 330), P=32, nkv=4, G=7),
    "G 12 at hd 64": dict(seed=6, lengths=(5, 0, 200), P=32, G=12, D=64, max_pages=8),
}


@functools.lru_cache(maxsize=None)
def _inputs_and_jax(case: str, int8: bool):
    c = _case(**CASES[case])
    if int8:
        args = [c[n] for n in ("q", "k8", "v8", "ks", "vs", "table", "lengths")]
        want = jpa.paged_prefix_attention_q8(*map(jnp.asarray, args), c["P"], interpret=True)
    else:
        args = [c[n] for n in ("q", "kp", "vp", "table", "lengths")]
        want = jpa.paged_prefix_attention(*map(jnp.asarray, args), c["P"], interpret=True)
    return c, [np.asarray(x) for x in want]


@pytest.mark.parametrize("rule", [True, False], ids=["wrapper's chunk", "4 tiles a chunk"])
@pytest.mark.parametrize("int8", [False, True], ids=["P1", "P2"])
@pytest.mark.parametrize("case", list(CASES))
def test_tc_rounding_stays_within_the_kernels_tolerance(case, int8, rule):
    """(a): the emulated tensor-core P1/P2 against JAX's kernel on the same
    bf16-valued q and the same pages."""
    c, (acc_w, m_w, l_w) = _inputs_and_jax(case, int8)
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items() if k != "P"}
    ct = pa.tc_chunk_tiles(c["table"].shape[1] * c["P"]) if rule else 4
    if int8:
        got = tc_paged(t["q"], t["k8"].float(), t["v8"].float(), t["ks"], t["vs"], t["table"], t["lengths"], c["P"], ct)
    else:
        got = tc_paged(t["q"], t["kp"], t["vp"], None, None, t["table"], t["lengths"], c["P"], ct)
    acc, m, l = (x.numpy() for x in got)
    live = c["lengths"] > 0
    for x, y in ((acc, acc_w), (m[live], m_w[live]), (l, l_w)):
        assert np.isfinite(x).all()
        assert np.abs(x - y).max() <= TC_TOL * np.abs(y).max()
    assert np.abs(acc - acc_w).max() > 0  # the rounding is there to see
    dead = ~live
    assert np.all(acc[dead] == 0) and np.all(m[dead] == np.float32(pa.NEG_INF)) and np.all(l[dead] == 0)


@pytest.mark.parametrize("view,G,int8,want", [
    (4096, 8, False, 2),  # phase 7: 32 pages of 128, the 3B's 8 rows: 32 chunks of 2 tiles
    (4096, 8, True, 2),  # int8 too
    (4096, 7, False, 2),  # the 7B's 7 rows
    (2112, 16, True, 2),  # 33 tiles: 2 a chunk for at most 32 chunks
    (2048, 16, False, 1),  # 32 tiles: one a chunk
    (512, 12, False, 1),  # 8 tiles
    (100, 8, False, 1),  # a view shorter than a tile
    (65536, 8, False, 4),  # past 32 chunks of 4 tiles: at most 4 tiles a chunk
])
def test_chunk_rule(view, G, int8, want):
    """(b): the chunk rule: at most TC_FOLD_CHUNKS chunks where 4 tiles
    allow, at most 4 tiles, and a chunk's f32 partials at most half the K/V
    they summarise."""
    ct = pa.tc_chunk_tiles(view)
    assert ct == want
    ntiles = -(-view // 64)
    assert 1 <= ct <= min(pa.TC_MAX_TILES, ntiles)
    assert G * 128 * 4 <= ct * 64 * 128 * (1 if int8 else 2) / 2  # at head dim 128
    if ct < pa.TC_MAX_TILES:
        assert -(-ntiles // ct) <= pa.TC_FOLD_CHUNKS


@pytest.mark.parametrize("ctiles", [1, 2, 4])
def test_partition_covers_each_live_key_once_and_one_block_folds(ctiles):
    """(b): for lengths around tile and chunk edges, past the view and
    negative, the live chunks' tiles cover [0, min(max(len, 0), view)) once,
    in order, in whole tiles but the last; in 20 arrival orders exactly one
    block draws the last ticket, and a slot of one chunk draws none."""
    view = 16 * 64
    rng = np.random.default_rng(ctiles)
    for length in (-3, 0, 1, 15, 16, 63, 64, 65, 127, 128, 129, 255, 256, 257, 1000, view - 1, view, view + 77):
        blocks = pa.tc_blocks(length, view, ctiles)
        n = min(max(length, 0), view)
        tiles = [t for b in blocks for t in b]
        assert [k for a, b in tiles for k in range(a, b)] == list(range(n))
        assert all(b - a == 64 for a, b in tiles[:-1]) and all(len(b) <= ctiles for b in blocks)
        nlive = -(-n // (64 * ctiles))  # the tickets each block of the slot expects: the kernel's count
        assert len(blocks) == nlive
        if nlive > 1:
            for _ in range(20):
                counter = itertools.count()  # the (slot, kv head)'s ticket, atomically incremented
                lasts = [b for b in rng.permutation(nlive).tolist() if next(counter) == nlive - 1]
                assert len(lasts) == 1 and next(counter) == nlive  # one folder; all arrived before the reset


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    """(c): given CPU tensors, P1 and P2 run their plain versions with q in
    bf16 and f32 and count no launch, tensor-core or FMA."""
    c = _case(seed=7, lengths=(0, 37, 300), P=16)
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items() if k != "P"}
    for fn in (pa.paged_prefix_attention, pa.paged_prefix_attention_q8):
        fn.launches = fn.tc_launches = 0
    for dtype in (torch.bfloat16, torch.float32):
        q = t["q"].to(dtype)
        p1 = (q, t["kp"].to(dtype), t["vp"].to(dtype), t["table"], t["lengths"], 16)
        p2 = (q, t["k8"], t["v8"], t["ks"], t["vs"], t["table"], t["lengths"], 16)
        for fn, plain, args in ((pa.paged_prefix_attention, pa.paged_prefix_attention_plain, p1),
                                (pa.paged_prefix_attention_q8, pa.paged_prefix_attention_q8_plain, p2)):
            for x, y in zip(fn(*args), plain(*args)):
                assert torch.equal(x, y)
    for fn in (pa.paged_prefix_attention, pa.paged_prefix_attention_q8):
        assert fn.launches == fn.tc_launches == 0
