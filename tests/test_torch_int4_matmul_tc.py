"""Q1's two kernels (`csrc/int4_matmul.cu`) from the CPU: what of them lives
in Python, and their arithmetic.

- `work_partition` gives every output row of the tensor-core kernel to
  exactly one block, balanced to one 16-row unit, at the Qwen2.5-VL 3B and
  7B products and a grid of one block per SM of an H100 (at most one per
  unit).
- `check_args` is the wrapper's one route rule: bf16 x with N % 16 == 0 and
  K % 128 == 0 takes the tensor-core kernel (every 3B and 7B product), f32 x
  and other bf16 shapes the FMA kernel; it refuses what no kernel takes.
  CPU tensors run the plain version and count no launch.
- An emulation of each kernel's arithmetic against the JAX package's Pallas
  kernel in interpret mode and the port's plain version. The tensor-core
  kernel: bf16 x, exact int4 values, 16-deep products in the k order of the
  mma fragments (product 2q + h of 128-deep block b takes k = 128b + 32t +
  8q + 2h + {0, 1, 4, 5} from each of the four threads t), a stage's blocks split over the
  warps (block b to warp b % 8), a warp's j-th block of a stage summed in f32
  into accumulator j % 2 in order, at the unit's end the two added and the
  eight warps' tiles summed in warp order, the scale on the f32 sum, one
  cast; stages of whole rows (K/2 <= 2048 bytes) and of row segments. The FMA kernel (the ragged shape): f32
  fused multiply-adds along k within each split of `k_splits`, the splits
  summed in order, the scale on the sum.

JAX's kernel runs on bf16-valued f32 x (XLA's CPU dot takes no bf16
operands with an f32 result); its bf16 output is that f32 result cast, as
the products are exact and both sum in f32. Tolerances, relative to the
largest output: 1e-6 in f32 (the same exact products summed in another
order); cast to bf16, each element within one bf16 step of JAX's (2^-7 of
the larger of the two, plus 1e-6 of the largest for values that cancel):
the two round f32 sums taken in other orders; against the plain version in
bf16, which rounds the product to bf16 before its bf16 scale (a second
rounding), 1e-2 as on the card (`chip_smoke.QUANT_TOL`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from time_r1_tpu.ops import quant as jq
from time_r1_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from time_r1_tpu_torch.ops import int4_matmul as i4
from time_r1_tpu_torch.ops.quant import quantize_weight, unpack_q4

torch.set_num_threads(2)

WARPS = 8  # csrc/int4_matmul.cu: consumer warps splitting each stage's 128-deep blocks
NACC = 2  # and each warp's accumulators
SHAPES = {  # (N, K) of the int4 decode products: qkv, o, gu, down
    "3B": [(2560, 2048), (2048, 2048), (22016, 2048), (2048, 11008)],
    "7B": [(4608, 3584), (3584, 3584), (37888, 3584), (3584, 18944)],
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.swapaxes(np.asarray(a), -1, -2), order="C"))


@pytest.mark.parametrize("model", ["3B", "7B"])
def test_q1_partition_covers_each_row_once(model):
    for N, _ in SHAPES[model]:
        ranges = i4.work_partition(N)
        assert len(ranges) == min(N // i4.UNIT, i4.SM_COUNT)
        hits = np.zeros(N, dtype=int)
        for a, b in ranges:
            assert a % i4.UNIT == 0 and b % i4.UNIT == 0 and a < b
            hits[a:b] += 1
        assert (hits == 1).all()
        sizes = [b - a for a, b in ranges]
        assert max(sizes) - min(sizes) <= i4.UNIT  # balanced to one unit


@pytest.mark.parametrize("model", ["3B", "7B"])
def test_q1_every_model_product_takes_the_tensor_cores(model):
    for N, K in SHAPES[model]:
        x, w4, s = torch.zeros((8, K), dtype=torch.bfloat16), torch.zeros((N, K // 2), dtype=torch.uint8), torch.ones(N)
        assert i4.check_args(x, w4, s)
        assert not i4.check_args(x.float(), w4, s)  # f32 x: the exact FMA kernel


@pytest.mark.parametrize("N,K", [(300, 1000), (2056 - 4, 2048), (2048, 2048 + 64), (16, 64)])
def test_q1_ragged_bf16_takes_the_fma_kernel(N, K):
    x, w4, s = torch.zeros((3, K), dtype=torch.bfloat16), torch.zeros((N, K // 2), dtype=torch.uint8), torch.ones(N)
    assert not i4.check_args(x, w4, s)


def test_q1_refuses_what_no_kernel_takes():
    x, w4, s = torch.zeros((8, 256), dtype=torch.bfloat16), torch.zeros((64, 128), dtype=torch.uint8), torch.ones(64)
    bad = [
        (x.half(), w4, s),  # f16 x
        (x, w4[:, :-16].contiguous(), s),  # w4 of the wrong width
        (x, w4.to(torch.int8), s),  # w4 not uint8
        (x, w4, s.double()),  # f64 scales
        (x, w4, s[:-1]),  # a scale short
        (torch.zeros((256, 8), dtype=torch.bfloat16).t(), w4, s),  # non-contiguous x
        (x[None], w4, s),  # 3-D x
        (x[:0], w4, s),  # no rows
    ]
    for args in bad:
        with pytest.raises(ValueError):
            i4.check_args(*args)


def test_q1_cpu_runs_plain_without_a_launch():
    g = torch.Generator().manual_seed(5)
    w = quantize_weight(torch.randn((64, 256), generator=g), bits=4)
    x = torch.randn((8, 256), generator=g).to(torch.bfloat16)
    n0, tc0 = i4.int4_matmul.launches, i4.int4_matmul.tc_launches
    assert torch.equal(i4.int4_matmul(x, w["q4"], w["s"]), i4.int4_matmul_plain(x, w["q4"], w["s"]))
    assert (i4.int4_matmul.launches, i4.int4_matmul.tc_launches) == (n0, tc0)
    with pytest.raises(ValueError):  # the launch itself takes only CUDA tensors
        i4._launch(x, w["q4"], w["s"])
    assert (i4.int4_matmul.launches, i4.int4_matmul.tc_launches) == (n0, tc0)


def _emulate_tc(xb: torch.Tensor, w4: torch.Tensor, s: torch.Tensor, grid: int) -> torch.Tensor:
    """The tensor-core kernel's f32 y (before the cast) from bf16-valued f32 x."""
    M, K = xb.shape
    q = unpack_q4(w4).float()
    y = torch.zeros((M, w4.shape[0]))
    mt = 8 if M <= 8 else 16
    # k of product 2q + h of a 128-deep block: four from each thread t, as the fragments pair them
    order = [[32 * t + 8 * q + 2 * h + d for t in range(4) for d in (0, 1, 4, 5)] for q in range(4) for h in range(2)]
    seg = i4.stage_row_bytes(M, K) // 64  # 128-deep blocks of a full stage
    for a, b in i4.work_partition(w4.shape[0], grid):
        for r0 in range(a, b, i4.UNIT):
            rows = slice(r0, r0 + i4.UNIT)
            for m0 in range(0, M, mt):
                xt = xb[m0:m0 + mt]
                acc = [[torch.zeros((i4.UNIT, xt.shape[0])) for _ in range(NACC)] for _ in range(WARPS)]
                for blk in range(K // 128):
                    kb = blk % seg  # within its stage
                    w, j = kb % WARPS, kb // WARPS
                    for ks in order:
                        kk = [128 * blk + k for k in ks]
                        acc[w][j % NACC] = acc[w][j % NACC] + q[rows][:, kk] @ xt[:, kk].t()
                total = torch.zeros_like(acc[0][0])
                for w in range(WARPS):
                    total = total + (acc[w][0] + acc[w][1])
                y[m0:m0 + mt, rows] = (total * s[rows].reshape(-1, 1)).t()
    return y


def _emulate_fma(x: torch.Tensor, w4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The FMA kernel's f32 y: per split, f32 fmas along k; splits summed in order."""
    M, K = x.shape
    q = unpack_q4(w4).double().numpy()
    xd = x.float().double().numpy()
    per, splits = i4.k_splits(M, K, w4.shape[0])
    total = np.zeros((M, w4.shape[0]), np.float32)
    for sp in range(splits):
        acc = np.zeros_like(total)
        for k in range(sp * per, min(K, (sp + 1) * per)):
            acc = (acc.astype(np.float64) + xd[:, k:k + 1] * q[:, k]).astype(np.float32)  # one rounding: fmaf
        total = total + acc
    return torch.from_numpy(total * s.reshape(-1).numpy())


def _case(M, N, K, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    w = jq.quantize_weight(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4)
    return x, w


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (np.abs(got - want).max(), np.abs(want).max())


def _bf16(a) -> np.ndarray:
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _within_a_bf16_step(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    slack = 2.0**-7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= slack).all(), np.abs(got - want).max()


@pytest.mark.parametrize("M,N,K,grid", [(1, 64, 256, 3), (8, 48, 4096, 2), (16, 32, 4352, 2), (200, 64, 256, 3),
                                        (256, 32, 4352, 2)])
def test_q1_tensor_core_arithmetic_matches_jax(M, N, K, grid):
    """K 4096: whole-row stages of 32 blocks (four a warp); K 4352: stages of
    2048 (M <= 8) or 1024-byte row segments, the last one short."""
    x, w = _case(M, N, K, seed=20 + M)
    w4, s = _t(w["q4"]), _t(w["s"])
    assert i4.check_args(x, w4, s)
    got = _emulate_tc(x.float(), w4, s, grid)
    xf = x.float().numpy()  # bf16-valued
    want = np.asarray(jax_int4_matmul(jnp.asarray(xf), w["q4"], w["s"], interpret=True))
    _close(got, want, 1e-6)
    _close(got, i4.int4_matmul_plain(x.float(), w4, s), 1e-6)
    _within_a_bf16_step(_bf16(got), _bf16(want))
    _close(_bf16(got), i4.int4_matmul_plain(x, w4, s).float(), 1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q1_fma_arithmetic_matches_jax_at_a_ragged_shape(dtype):
    M, N, K = 3, 300, 1000
    x, w = _case(M, N, K, seed=7)
    x = x.to(dtype)
    w4, s = _t(w["q4"]), _t(w["s"])
    assert not i4.check_args(x, w4, s)
    got = _emulate_fma(x, w4, s)
    want = np.asarray(jax_int4_matmul(jnp.asarray(x.float().numpy()), w["q4"], w["s"], interpret=True))
    _close(got, want, 1e-6)
    _close(got, i4.int4_matmul_plain(x.float(), w4, s), 1e-6)
    if dtype is torch.bfloat16:
        _within_a_bf16_step(_bf16(got), _bf16(want))
