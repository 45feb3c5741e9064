"""The port's ring attention (`time_r1_tpu_torch/parallel/ring_attention.py`)
against the JAX package's on the CPU.

The port's ranks are processes joined by a gloo group over 127.0.0.1, set up
from torchrun's environment variables (`spawn_ranks`, which the other
multi-process tests use too); the JAX side runs `ring_attention_sharded` and
`ring_attention_zigzag_sharded` on the 8-device virtual mesh
(tests/conftest.py) for one case of each layout, and the other cases hold the
port's ring against JAX's single-device `flash_attention`, which is what JAX's
tests/test_ring_attention.py holds its ring to (JAX's ring compiles for 13-90
s a case on the CPU; its flash call for 1-4 s). One spawn of 8 ranks computes
every case, over groups of 2, 4 and 8 ranks: the contiguous layout (causal and
not) and the zig-zag layout, forward and the gradients of q, k and v (each
rank's part of the global gradient, summed over the ranks), key padding 0,
64, 128 and 192 and half the keys padded (no NaN where whole kv shards are
masked). Tolerances are those of JAX's tests/test_ring_attention.py: 2e-5
forward, 5e-5 gradients.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

B, S, H, HKV, D = 2, 1024, 4, 2, 64
NEG_INF = -1e30

# (name, layout, n, causal, pad, grads); the cases named in JAX_RING are held
# against JAX's ring, the others against JAX's flash_attention
JAX_RING = ("fwd_n4_causal", "zz_fwd_n2")
CASES = [
    ("fwd_n4_causal", "contiguous", 4, True, 0, False),
    ("fwd_n8_causal_pad192", "contiguous", 8, True, 192, False),
    ("fwd_n4_full_pad64", "contiguous", 4, False, 64, False),
    ("fwd_n2_causal_pad128", "contiguous", 2, True, 128, False),
    ("grad_n4_causal_pad128", "contiguous", 4, True, 128, True),
    ("grad_n2_full_pad64", "contiguous", 2, False, 64, True),
    ("grad_n8_causal", "contiguous", 8, True, 0, True),
    ("half_padded_n8_full", "contiguous", 8, False, S // 2, False),
    ("zz_fwd_n2", "zigzag", 2, True, 0, False),
    ("zz_fwd_n4_pad192", "zigzag", 4, True, 192, False),
    ("zz_fwd_n4_pad64", "zigzag", 4, True, 64, False),
    ("zz_grad_n4_pad128", "zigzag", 4, True, 128, True),
    ("zz_grad_n2", "zigzag", 2, True, 0, True),
]


def spawn_ranks(module: str, fn: str, world: int, workdir, timeout: float = 300.0) -> list:
    """Run `module.fn(rank, world, workdir)` in `world` processes, with
    torchrun's environment variables for a gloo group over 127.0.0.1 on a
    free port, one thread each. Waits at most `timeout` seconds for all of
    them (a rank that hangs or dies fails the test and the others are
    killed); returns each rank's `workdir/rank{r}.pt`."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        code = (f"import sys; sys.path[:0] = [{HERE!r}, {REPO!r}]; import {module} as m; "
                f"m.{fn}({r}, {world}, {str(workdir)!r})")
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=log, stderr=subprocess.STDOUT,
                                      cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{module}.{fn}: a rank of {world} did not finish in {timeout:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                pytest.fail(f"{module}.{fn}: rank {r} exited {p.returncode}:\n{f.read()[-3000:]}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _inputs(case_index: int, pad: int):
    rng = np.random.default_rng(case_index)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    bias = np.zeros((B, S), np.float32)
    if pad:
        bias[:, S - pad:] = NEG_INF
    ct = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, bias, ct


def _worker(rank: int, world: int, workdir: str) -> None:
    """Every case on the ranks of its group (the first n ranks); rank 0
    saves the gathered outputs and the summed gradients."""
    import torch.distributed as dist

    from time_r1_tpu_torch.parallel import maybe_init_distributed, ring_attention_sharded, ring_attention_zigzag_sharded
    from time_r1_tpu_torch.parallel.comm import all_reduce_sum

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu") == torch.device("cpu")
    groups = {n: dist.new_group(list(range(n))) for n in (2, 4, 8)}  # every rank creates every group
    out = {}
    for ci, (name, layout, n, causal, pad, grads) in enumerate(CASES):
        if rank >= n:
            continue
        q, k, v, bias, ct = (torch.from_numpy(a) for a in _inputs(ci, pad))
        qkv = [t.clone().requires_grad_(grads) for t in (q, k, v)]
        if layout == "zigzag":
            o = ring_attention_zigzag_sharded(*qkv, bias, groups[n])
        else:
            o = ring_attention_sharded(*qkv, bias, groups[n], causal=causal)
        res = {"out": o.detach()}
        if grads:
            g = list(torch.autograd.grad((o * ct).sum(), qkv))
            all_reduce_sum(g, groups[n])
            res["grads"] = g
        out[name] = res
    if rank == 0:
        torch.save(out, os.path.join(workdir, "rank0.pt"))
    else:
        torch.save({}, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    return spawn_ranks("test_torch_ring_attention", "_worker", 8, tmp_path_factory.mktemp("ring"))[0]


def _jax_case(ci, layout, n, causal, pad, grads):
    import jax
    import jax.numpy as jnp

    from time_r1_tpu.ops.flash_attention import flash_attention
    from time_r1_tpu.parallel.ring_attention import ring_attention_sharded, ring_attention_zigzag_sharded

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(n), ("data",))
    q, k, v, bias, ct = (jnp.asarray(a) for a in _inputs(ci, pad))

    def fn(q, k, v):
        if CASES[ci][0] not in JAX_RING:
            return flash_attention(q, k, v, bias, causal)
        if layout == "zigzag":
            return ring_attention_zigzag_sharded(q, k, v, bias, mesh)
        return ring_attention_sharded(q, k, v, bias, mesh, causal=causal)

    out = fn(q, k, v)
    g = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * ct), argnums=(0, 1, 2))(q, k, v) if grads else None
    return np.asarray(out), g


@pytest.mark.parametrize("ci", range(len(CASES)), ids=[c[0] for c in CASES])
def test_ring_matches_jax(port_results, ci):
    name, layout, n, causal, pad, grads = CASES[ci]
    want, want_g = _jax_case(ci, layout, n, causal, pad, grads)
    got = port_results[name]
    assert np.isfinite(got["out"].numpy()).all()
    np.testing.assert_allclose(got["out"].numpy(), want, atol=2e-5, rtol=2e-5)
    if grads:
        for a, b, which in zip(got["grads"], want_g, "qkv"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=5e-5, err_msg=f"d{which}")


@pytest.mark.parametrize("S_, n", [(16, 2), (1024, 4), (2048, 8)])
def test_zigzag_indices_match_jax(S_, n):
    from time_r1_tpu.parallel.ring_attention import zigzag_indices as jax_zz
    from time_r1_tpu.parallel.ring_attention import zigzag_inverse as jax_inv
    from time_r1_tpu_torch.parallel import zigzag_indices, zigzag_inverse

    np.testing.assert_array_equal(zigzag_indices(S_, n), jax_zz(S_, n))
    np.testing.assert_array_equal(zigzag_inverse(S_, n), jax_inv(S_, n))
    np.testing.assert_array_equal(zigzag_indices(S_, n)[zigzag_inverse(S_, n)], np.arange(S_))


def test_merge_of_empty_partials_is_finite():
    """Two empty partials (NEG_INF lse) merge to a finite zero output, as
    JAX's `_merge` does."""
    from time_r1_tpu_torch.parallel.ring_attention import _merge

    out = torch.zeros((1, 4, 2, 8))
    lse = torch.full((1, 2, 4), NEG_INF)
    o, l_ = _merge(out, lse, None, torch.full_like(lse, NEG_INF))
    assert torch.isfinite(o).all() and torch.isfinite(l_).all() and float(o.abs().max()) == 0.0
