"""P1 and P2 (`time_r1_tpu_torch/ops/paged_attention.py`) on the CPU: the plain
versions against the JAX package's Pallas kernels (interpret mode) and its
gather-view references, on the inputs of tests/test_paged_attention.py; the
empty-prefix state; `combine_with_new_token` against JAX's and a concat
softmax; the wrappers' dispatch and argument checks.

Tolerances are the JAX tests' own: m at 1e-5, l at 1e-4, acc at rtol 1e-4 /
atol 1e-3 (f32 sums of up to 300 keys in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from time_r1_tpu.ops import paged_attention as jpa
from time_r1_tpu.ops.quant import quantize_kv as jax_quantize_kv
from time_r1_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)

NKV, G, HD, SLOTS = 2, 4, 128, 3


def _setup(seed=0, lengths=(0, 100, 300), P=128):
    """tests/test_paged_attention.py's inputs: a non-trivial page table over
    a pool whose page 0 is reserved as scratch, at page size P."""
    rng = np.random.default_rng(seed)
    max_pages = max(3, max(-(-n // P) for n in lengths))
    n_pages = 1 + sum(-(-n // P) for n in lengths) + 4
    q = rng.normal(size=(SLOTS, NKV, G, HD)).astype(np.float32)
    k_pages = rng.normal(size=(NKV, n_pages, P, HD)).astype(np.float32)
    v_pages = rng.normal(size=(NKV, n_pages, P, HD)).astype(np.float32)
    pt = np.zeros((SLOTS, max_pages), np.int32)
    free = list(range(1, n_pages))
    for s, ln in enumerate(lengths):
        for j in range(-(-ln // P)):
            pt[s, j] = free.pop()
    return q, k_pages, v_pages, pt, np.array(lengths, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_state(got, want):
    acc, m, l = (np.asarray(x) for x in got)
    acc_w, m_w, l_w = (np.asarray(x) for x in want)
    np.testing.assert_allclose(m, m_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(acc, acc_w, rtol=1e-4, atol=1e-3)


CASES = [((0, 100, 300), 128), ((128, 256, 37), 128), ((0, 37, 300), 16)]


@pytest.mark.parametrize("lengths,P", CASES)
def test_p1_plain_matches_jax_kernel_and_reference(lengths, P):
    q, kp, vp, pt, ln = _setup(lengths=lengths, P=P)
    got = pa.paged_prefix_attention_plain(*_torch(q, kp, vp, pt, ln), P)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, pt, ln)]
    _assert_state(got, jpa.paged_prefix_attention(*jargs, P, interpret=True))
    _assert_state(got, jpa.paged_prefix_attention_reference(*jargs, P))


def _quantized(kp, vp):
    """Both pools' int8 pages and scales from JAX's quantize_kv."""
    k8, ks = jax_quantize_kv(jnp.asarray(kp))
    v8, vs = jax_quantize_kv(jnp.asarray(vp))
    return [np.asarray(x) for x in (k8, v8, ks, vs)]


@pytest.mark.parametrize("lengths,P", CASES)
def test_p2_plain_matches_jax_kernel_and_reference(lengths, P):
    q, kp, vp, pt, ln = _setup(seed=3, lengths=lengths, P=P)
    k8, v8, ks, vs = _quantized(kp, vp)
    got = pa.paged_prefix_attention_q8_plain(*_torch(q, k8, v8, ks, vs, pt, ln), P)
    jargs = [jnp.asarray(a) for a in (q, k8, v8, ks, vs, pt, ln)]
    _assert_state(got, jpa.paged_prefix_attention_q8(*jargs, P, interpret=True))
    _assert_state(got, jpa.paged_prefix_attention_q8_reference(*jargs, P))


def test_empty_prefix_state_is_exact():
    """An empty prefix gives m = -1e30, l = 0 and acc = 0 exactly, in both
    plain versions, as the JAX kernel's initial state."""
    q, kp, vp, pt, ln = _setup(lengths=(0, 0, 0))
    k8, v8, ks, vs = _quantized(kp, vp)
    for acc, m, l in (pa.paged_prefix_attention_plain(*_torch(q, kp, vp, pt, ln), 128),
                      pa.paged_prefix_attention_q8_plain(*_torch(q, k8, v8, ks, vs, pt, ln), 128)):
        assert torch.all(m == pa.NEG_INF) and torch.all(l == 0) and torch.all(acc == 0)
    acc_j, m_j, l_j = jpa.paged_prefix_attention(*[jnp.asarray(a) for a in (q, kp, vp, pt, ln)], 128,
                                                 interpret=True)
    assert np.all(np.asarray(m_j) == np.float32(pa.NEG_INF)) and np.all(np.asarray(l_j) == 0)


def test_stale_table_of_an_empty_slot_reads_nothing():
    """A dead slot (length 0) whose stale table row points at another slot's
    pages gets the empty state, and the other slots are unchanged."""
    q, kp, vp, pt, ln = _setup(lengths=(0, 100, 300))
    stale = pt.copy()
    stale[0] = pt[2]
    a, b = (pa.paged_prefix_attention_plain(*_torch(q, kp, vp, t, ln), 128) for t in (pt, stale))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lengths", [(0, 100, 300), (128, 256, 37)])
def test_combine_with_new_token_matches_jax_and_concat_softmax(lengths):
    q, kp, vp, pt, ln = _setup(seed=1, lengths=lengths)
    rng = np.random.default_rng(2)
    k_new = rng.normal(size=(SLOTS, NKV, HD)).astype(np.float32)
    v_new = rng.normal(size=(SLOTS, NKV, HD)).astype(np.float32)
    acc, m, l = pa.paged_prefix_attention_plain(*_torch(q, kp, vp, pt, ln), 128)
    got = pa.combine_with_new_token(acc, m, l, *_torch(q, k_new, v_new)).numpy()

    jstate = [jnp.asarray(x.numpy()) for x in (acc, m, l)]
    want = np.asarray(jpa.combine_with_new_token(*jstate, *[jnp.asarray(a) for a in (q, k_new, v_new)]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    max_pages, P = pt.shape[1], 128
    k_view = kp[:, pt].reshape(NKV, SLOTS, max_pages * P, HD)
    v_view = vp[:, pt].reshape(NKV, SLOTS, max_pages * P, HD)
    for s in range(SLOTS):
        n = int(ln[s])
        for h in range(NKV):
            keys = np.concatenate([k_view[h, s, :n], k_new[s, h][None]])
            vals = np.concatenate([v_view[h, s, :n], v_new[s, h][None]])
            sc = keys.astype(np.float64) @ q[s, h].T.astype(np.float64) * HD**-0.5  # (n + 1, G)
            p = np.exp(sc - sc.max(0))
            np.testing.assert_allclose(got[s, h], (p / p.sum(0)).T @ vals, rtol=1e-4, atol=1e-4)


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    q, kp, vp, pt, ln = _setup(lengths=(0, 37, 300), P=16)
    k8, v8, ks, vs = _quantized(kp, vp)
    n1, n2 = pa.paged_prefix_attention.launches, pa.paged_prefix_attention_q8.launches
    for got, want in (
        (pa.paged_prefix_attention(*_torch(q, kp, vp, pt, ln), 16),
         pa.paged_prefix_attention_plain(*_torch(q, kp, vp, pt, ln), 16)),
        (pa.paged_prefix_attention_q8(*_torch(q, k8, v8, ks, vs, pt, ln), 16),
         pa.paged_prefix_attention_q8_plain(*_torch(q, k8, v8, ks, vs, pt, ln), 16)),
    ):
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert (pa.paged_prefix_attention.launches, pa.paged_prefix_attention_q8.launches) == (n1, n2)


def _launch_args(quant=False, **over):
    q, kp, vp, pt, ln = _torch(*_setup(lengths=(0, 37, 300), P=16))
    args = dict(q=q, k_pages=kp, v_pages=vp, k_scale=None, v_scale=None, page_table=pt, lengths=ln, page_size=16)
    if quant:
        k8, v8, ks, vs = _torch(*_quantized(kp.numpy(), vp.numpy()))
        args.update(k_pages=k8, v_pages=v8, k_scale=ks, v_scale=vs)
    args.update(over)
    return args


@pytest.mark.parametrize("quant,over,match", [
    (False, {}, "CUDA tensors"),
    (True, {}, "CUDA tensors"),
    (False, {"q": torch.zeros(SLOTS, NKV, G, 80)}, "head dim 80"),
    (False, {"q": torch.zeros(SLOTS, NKV, HD, G).transpose(2, 3)}, "q must be contiguous"),
    (False, {"page_size": 32}, "pages must be"),
    (False, {"lengths": torch.zeros(SLOTS, dtype=torch.int64)}, "lengths must be"),
    (False, {"page_table": torch.zeros(SLOTS, 19, dtype=torch.int64)}, "page_table must be"),
    (True, {"k_scale": torch.zeros(NKV, 4, 16)}, "scales must be"),
])
def test_launch_checks_its_operands(quant, over, match):
    """What the kernels do not take raises before any launch; with every
    operand right, CPU tensors are refused as not CUDA."""
    a = _launch_args(quant, **over)
    with pytest.raises(ValueError, match=match):
        pa._launch("paged_prefix_attention", a["q"], a["k_pages"], a["v_pages"], a["k_scale"], a["v_scale"],
                   a["page_table"], a["lengths"], a["page_size"])
