"""The optimizer state in host memory (`offload_optimizer`, the JAX trainer's
`TrainConfig.offload_optimizer`), f32 and bf16 on the CPU, tiny config:

- `AdamWMultiSteps.init(..., offload=True)` over leaves of several sizes: the
  leaves that JAX's `_offloadable` rule selects (a dimension and at least
  1024 elements) are views of one host arena per tree whose bytes are
  exactly theirs, the others stay where they were; over 6 micro-steps at k =
  1, 2 and 3 with the clip active, every parameter and every moment and
  accumulation leaf is bit-equal to the device-resident optimizer's, with
  the copies in and out counted as the streaming schedule makes them;
- two `GRPOTrainer.step_batch` calls with `offload_optimizer=True` against
  the JAX trainer with it (on the CPU JAX really places the state in its
  `pinned_host` memory), within tests/test_torch_trainer.py's tolerances,
  and bit-equal to the port's trainer without offload;
- LoRA with offload (rank 16, so that some factors are offloaded and some
  are not): the adapters and their state bit-equal to LoRA without;
- a resume with offload (save_only_model=False): the restored state back in
  the host arenas, and two more steps bit-equal to an uninterrupted run.

On the CPU the host state is ordinary memory (torch without CUDA cannot
pin); on the card chip_smoke.py phase 12 checks that it is page-locked."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_trainer import EXAMPLE, Processor, _completions, _config, _request, spread_reward
from time_r1_tpu.rl import GRPOTrainer as JaxTrainer
from time_r1_tpu.rl import TrainConfig as JaxTrainConfig
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.utils.rewards import REWARD_FUNCS_REGISTRY as JAX_REWARDS
from time_r1_tpu_torch.models.qwen25vl import params_to_jax
from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
from time_r1_tpu_torch.rl.optim import AdamWMultiSteps, offloadable
from time_r1_tpu_torch.sampler import Request
from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

torch.set_num_threads(2)

SHAPES = [(40, 30), (7,), (2, 32, 20), (1024,), (3, 5), (1023,)]


def _trees_equal(a, b) -> bool:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _in_arena(t: torch.Tensor, arena) -> bool:
    base = arena.buffer.data_ptr()
    return t.device.type == "cpu" and base <= t.data_ptr() < base + arena.nbytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("every_k", [1, 2, 3])
def test_offloaded_optimizer_is_bit_equal(dtype, every_k):
    rng = np.random.default_rng(0)
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype) for s in SHAPES]
    grads = [[torch.from_numpy((rng.normal(size=s) * 3).astype(np.float32)).to(dtype) for s in SHAPES]
             for _ in range(6)]
    hyper = dict(learning_rate=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, max_grad_norm=1.0,
                 every_k=every_k)
    a, b = [p.clone() for p in params], [p.clone() for p in params]
    oa, ob = AdamWMultiSteps(**hyper), AdamWMultiSteps(**hyper)
    sa, sb = oa.init(a), ob.init(b, offload=True)

    host = [offloadable(p) for p in params]
    assert host == [True, False, True, True, False, False]  # JAX's rule: ndim >= 1 and size >= 1024
    trees = ("mu", "nu", "acc") if every_k > 1 else ("mu", "nu")
    assert sorted(sb.arenas) == sorted(trees)
    leaf_bytes = sum(p.numel() * p.element_size() for p, h in zip(params, host) if h)
    assert all(sb.arenas[n].nbytes == leaf_bytes for n in trees) and sb.host_bytes == len(trees) * leaf_bytes
    for n in trees:
        for t, p, h in zip(getattr(sb, n), b, host):
            assert _in_arena(t, sb.arenas[n]) == h and t.shape == p.shape and t.dtype == p.dtype
            assert not t.is_pinned()  # ordinary memory on the CPU
    for t in sb.arenas["mu"].views:
        assert t.abs().max() == 0

    streamed = []
    for step, g in enumerate(grads):
        assert sum(float((x.float() ** 2).sum()) for x in g) > 1.0  # the clip is active
        ca = oa.update(a, [x.clone() for x in g], sa)
        cb = ob.update(b, [x.clone() for x in g], sb)
        assert ca == cb == ((step + 1) % every_k == 0)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), step
        ta, tb = sa.tree(), sb.tree()
        for n in trees:
            assert all(torch.equal(x, y) for x, y in zip(ta[n], tb[n])), (step, n)
        assert (int(tb["count"]), int(tb["mini_step"])) == (sa.count, sa.mini_step)
        streamed.append(dict(ob.last_stream))
    # per update: mu and nu in and out; per window: acc out on its first
    # micro-step, in and out on those between, in on the last
    mn = 2 * leaf_bytes
    want = {1: [(mn, mn)] * 6,
            2: [(0, leaf_bytes), (leaf_bytes + mn, mn)] * 3,
            3: [(0, leaf_bytes), (leaf_bytes, leaf_bytes), (leaf_bytes + mn, mn)] * 2}[every_k]
    assert [(s["h2d_bytes"], s["d2h_bytes"]) for s in streamed] == want


def _jax_trainer(jp, jref, comps, monkeypatch, **kw):
    tr = JaxTrainer(jp, JCFG, Processor(), [JAX_REWARDS["iou"], JAX_REWARDS["format"], spread_reward],
                    config=_config(JaxTrainConfig, **kw), ref_params=jref, dtype=jnp.float32)
    monkeypatch.setattr(tr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
    return tr


def _port_trainer(jp, jref, comps, monkeypatch, **kw):
    tr = GRPOTrainer(port_params(jp), CFG, Processor(), [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"],
                                                         spread_reward],
                     config=_config(TrainConfig, **kw), ref_params=None if jref is None else port_params(jref),
                     dtype=torch.float32, device="cpu")
    monkeypatch.setattr(tr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
    return tr


def _step(tr, ids, patches, request=Request):
    return tr.step_batch([EXAMPLE], [request(ids, patches, (2, 4, 4), 1.0)])


def test_offloaded_trainer_matches_jax_and_the_device_state(monkeypatch):
    jp = jax_params()
    jref = jax.tree.map(lambda x: x * 0.9, jp)
    ids, patches = _request(np.random.default_rng(3))
    comps = _completions(4)
    jtr = _jax_trainer(jp, jref, comps, monkeypatch, offload_optimizer=True)
    assert jtr._opt_sharding is not None  # JAX's offload really placed the state in pinned_host memory
    off = _port_trainer(jp, jref, comps, monkeypatch, offload_optimizer=True)
    dev = _port_trainer(jp, jref, comps, monkeypatch)
    assert any(off.opt_state.offloaded) and not any(dev.opt_state.offloaded)
    before = params_to_jax(off.params, CFG)
    for _ in range(2):
        want = _step(jtr, ids, patches, JaxRequest)
        got = _step(off, ids, patches)
        assert _step(dev, ids, patches) == got
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-5, abs=2e-6)
    jm, tm = jtr.pop_metrics(), off.pop_metrics()
    assert tm == dev.pop_metrics()
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert off.opt_state.count == 1
    assert _trees_equal(off.params, dev.params) and _trees_equal(off.opt_state.tree(), dev.opt_state.tree())
    after_j, after_t = jax.tree.map(np.asarray, jtr.params), params_to_jax(off.params, CFG)
    for (path, a), (_, b), (_, b0) in zip(jax.tree_util.tree_flatten_with_path(after_j)[0],
                                          jax.tree_util.tree_flatten_with_path(after_t)[0],
                                          jax.tree_util.tree_flatten_with_path(before)[0]):
        np.testing.assert_allclose(b - b0, a - b0, atol=2e-6, rtol=0, err_msg=jax.tree_util.keystr(path))
    host = off.opt_state.offloaded
    assert any(host) and not all(host)  # the norms' scales (size < 1024) stay in place
    for n, arena in off.opt_state.arenas.items():
        assert all(_in_arena(t, arena) == h for t, h in zip(getattr(off.opt_state, n), host))


def test_offloaded_lora_trainer_is_bit_equal(monkeypatch):
    jp = jax_params()
    ids, patches = _request(np.random.default_rng(3))
    comps = _completions(4)
    peft = dict(use_peft=True, lora_r=16, lora_alpha=32.0)  # rank 16: some factors reach 1024 elements
    off = _port_trainer(jp, None, comps, monkeypatch, offload_optimizer=True, **peft)
    dev = _port_trainer(jp, None, comps, monkeypatch, **peft)
    with torch.no_grad():  # B away from 0, the same in both
        for a, b in zip(jax.tree.leaves(off.lora), jax.tree.leaves(dev.lora)):
            a.add_(0.01)
            b.add_(0.01)
    for _ in range(4):
        assert _step(off, ids, patches) == _step(dev, ids, patches)
    assert off.opt_state.count == 2 and off.pop_metrics() == dev.pop_metrics()
    assert _trees_equal(off.lora, dev.lora) and _trees_equal(off.opt_state.tree(), dev.opt_state.tree())
    from time_r1_tpu_torch.rl.lora import lora_leaves

    leaves, host = lora_leaves(off.lora), off.opt_state.offloaded
    assert host == [offloadable(t) for t in leaves] and any(host) and not all(host)
    assert off.opt_state.host_bytes == 3 * sum(t.numel() * t.element_size() for t, h in zip(leaves, host) if h)


def test_offloaded_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    jp = jax_params()
    jref = jax.tree.map(lambda x: x * 0.9, jp)
    ids, patches = _request(np.random.default_rng(3))
    comps = _completions(4)
    kw = dict(offload_optimizer=True, save_only_model=False)
    whole = _port_trainer(jp, jref, comps, monkeypatch, **kw)
    first = _port_trainer(jp, jref, comps, monkeypatch, **kw)
    for _ in range(3):  # one update, then a window half full: acc holds a micro-step
        _step(whole, ids, patches)
        _step(first, ids, patches)
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = _port_trainer(jp, jref, comps, monkeypatch, **kw)
    arenas = {n: a.buffer.data_ptr() for n, a in resumed.opt_state.arenas.items()}
    resumed.load_checkpoint_state(str(tmp_path / "ck"))
    assert (resumed.global_step, resumed.opt_state.count, resumed.opt_state.mini_step) == (3, 1, 1)
    assert {n: a.buffer.data_ptr() for n, a in resumed.opt_state.arenas.items()} == arenas  # restored in place
    for n, arena in resumed.opt_state.arenas.items():
        assert all(_in_arena(t, arena) == h for t, h in zip(getattr(resumed.opt_state, n),
                                                            resumed.opt_state.offloaded))
    assert _trees_equal(resumed.params, first.params)
    assert _trees_equal(resumed.opt_state.tree(), first.opt_state.tree())
    st = resumed.opt_state
    assert any(float(a.abs().max()) > 0 for a, h in zip(st.acc, st.offloaded) if h)  # the half-full window came back
    for _ in range(3):
        _step(whole, ids, patches)
        _step(resumed, ids, patches)
    assert resumed.opt_state.count == whole.opt_state.count == 3
    assert _trees_equal(resumed.params, whole.params)
    assert _trees_equal(resumed.opt_state.tree(), whole.opt_state.tree())
    dev = _port_trainer(jp, jref, comps, monkeypatch, save_only_model=False)
    for _ in range(6):
        _step(dev, ids, patches)
    assert _trees_equal(dev.params, whole.params) and _trees_equal(dev.opt_state.tree(), whole.opt_state.tree())
