"""Q2's one-launch tensor-core kernel (`csrc/fused_mlp.cu`) from the CPU: what
of it lives in Python, and its decomposition.

- `work_partition` gives every `inter` column (phase A) and every output row
  (phase B) to exactly one block, at the 3B and 7B widths and the grids of
  one and two blocks per SM of an H100.
- The wrapper's shape checks refuse, before any launch, what the kernel does
  not take: inter % 16 != 0, hid % 128 != 0, M outside 1..128; CPU tensors
  run the plain version and count no launch.
- An emulation of the kernel's arithmetic order (blocks' unit ranges from
  `work_partition`, each unit's 64-deep k-blocks split over eight warps by
  index mod 8, the warps' partial tiles summed in warp order, the bf16
  activation, phase B over it) against the JAX package's Pallas kernel in
  interpret mode and the port's plain version: 1e-5 relative to the largest
  output (f32 sums in another order; an activation can cross a bf16
  rounding boundary in rare elements).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from time_r1_tpu.ops import quant as jq
from time_r1_tpu.ops.fused_mlp import fused_mlp_int8 as jax_fused_mlp
from time_r1_tpu_torch.ops import fused_mlp as fm
from time_r1_tpu_torch.ops.quant import quantize_weight

torch.set_num_threads(2)

WARPS = 8  # csrc/fused_mlp.cu: consumer warps splitting each stage's 64-deep blocks


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.swapaxes(np.asarray(a), -1, -2)))


@pytest.mark.parametrize("grid", [132, 264])
@pytest.mark.parametrize("hid,inter", [(2048, 11008), (3584, 18944)])
def test_q2_partition_covers_each_once(hid, inter, grid):
    cols, rows = fm.work_partition(inter, hid, grid)
    assert len(cols) == len(rows) == grid
    for ranges, n, unit in ((cols, inter, fm.GATE_UNIT), (rows, hid, fm.DOWN_UNIT)):
        hits = np.zeros(n, dtype=int)
        for a, b in ranges:
            assert a % unit == 0 and b % unit == 0 and a <= b
            hits[a:b] += 1
        assert (hits == 1).all()
        sizes = [b - a for a, b in ranges]
        assert max(sizes) - min(sizes) <= unit  # balanced to one unit


@pytest.mark.parametrize("M,hid,inter", [(8, 2048, 11000), (8, 2048, 11008 + 8), (129, 2048, 11008), (0, 2048, 11008),
                                         (8, 2000, 11008)])
def test_q2_shape_checks_refuse(M, hid, inter):
    with pytest.raises(ValueError):
        fm.check_shape(M, hid, inter)


@pytest.mark.parametrize("M,hid,inter", [(1, 2048, 11008), (128, 3584, 18944), (3, 256, 272)])
def test_q2_shape_checks_take(M, hid, inter):
    fm.check_shape(M, hid, inter)


def test_q2_cpu_runs_plain_without_a_launch():
    g = torch.Generator().manual_seed(4)
    gu = quantize_weight(torch.randn((32, 128), generator=g))
    dn = quantize_weight(torch.randn((128, 16), generator=g))
    args = (torch.randn((2, 128), generator=g), gu["q8"], gu["s"], dn["q8"], dn["s"])
    before = fm.fused_mlp_int8.launches
    assert torch.equal(fm.fused_mlp_int8(*args), fm.fused_mlp_int8_plain(*args))
    assert fm.fused_mlp_int8.launches == before
    with pytest.raises(ValueError):  # the launch itself takes only CUDA tensors
        fm._launch(*args)
    assert fm.fused_mlp_int8.launches == before


def _unit_sum(w8: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(rows, K) int8 against (M, K) bf16-valued f32 → (rows, M), as the
    kernel sums: k-block j (64 deep) to warp j % 8, each warp's blocks in
    order, then the eight partial tiles in warp order."""
    K = w8.shape[1]
    pad = -K % 64
    w, bb = F.pad(w8.float(), (0, pad)), F.pad(b, (0, pad))
    parts = [torch.zeros((w8.shape[0], b.shape[0]))] * WARPS
    for j in range(w.shape[1] // 64):
        ks = slice(64 * j, 64 * j + 64)
        parts[j % WARPS] = parts[j % WARPS] + w[:, ks] @ bb[:, ks].t()
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _emulate(x, gu8, gu_s, dn8, dn_s, grid):
    inter, hid = dn8.shape[1], x.shape[1]
    xb = x.to(torch.bfloat16).float()
    act = torch.zeros((x.shape[0], inter))
    cols, rows = fm.work_partition(inter, hid, grid)
    for a, b in cols:
        for n0 in range(a, b, fm.GATE_UNIT):
            n = slice(n0, n0 + fm.GATE_UNIT)
            tile = _unit_sum(torch.cat([gu8[n], gu8[inter + n0:inter + n0 + fm.GATE_UNIT]]), xb)
            g = tile[:8] * gu_s[n].reshape(-1, 1)
            u = tile[8:] * gu_s[inter + n0:inter + n0 + 8].reshape(-1, 1)
            act[:, n] = (F.silu(g) * u).t().to(torch.bfloat16).float()
    y = torch.zeros((x.shape[0], hid))
    for a, b in rows:
        for j0 in range(a, b, fm.DOWN_UNIT):
            j = slice(j0, j0 + fm.DOWN_UNIT)
            y[:, j] = (_unit_sum(dn8[j], act) * dn_s[j].reshape(-1, 1)).t()
    return y.to(x.dtype)


@pytest.mark.parametrize("M,grid", [(8, 7), (3, 5)])
def test_q2_decomposition_matches_jax(M, grid):
    rng = np.random.default_rng(10 + M)
    hid, inter = 256, 384
    x = rng.normal(size=(M, hid)).astype(np.float32)
    gu = jq.quantize_weight(jnp.asarray(rng.normal(size=(hid, 2 * inter)).astype(np.float32)))
    dn = jq.quantize_weight(jnp.asarray(rng.normal(size=(inter, hid)).astype(np.float32)))
    want = np.asarray(jax_fused_mlp(jnp.asarray(x), gu["q8"], gu["s"], dn["q8"], dn["s"], interpret=True))
    got = _emulate(torch.from_numpy(x), _t(gu["q8"]), _t(gu["s"]), _t(dn["q8"]), _t(dn["s"]), grid).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_q2_decomposition_matches_plain_at_a_port_only_shape():
    """inter 272: phase B's last 64-deep block is ragged (the kernel reads
    the activation's zero pad); JAX's blocks do not take it."""
    g = torch.Generator().manual_seed(3)
    hid, inter, M = 256, 272, 3
    gu = quantize_weight(torch.randn((2 * inter, hid), generator=g))
    dn = quantize_weight(torch.randn((hid, inter), generator=g))
    x = torch.randn((M, hid), generator=g)
    args = (x, gu["q8"], gu["s"], dn["q8"], dn["s"])
    got, want = _emulate(*args, grid=4), fm.fused_mlp_int8_plain(*args)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
