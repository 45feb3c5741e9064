"""The port's `GRPOTrainer.train()` against the JAX package's (f32, CPU, tiny
config):

- the lr schedules (`rl/optim.py::linear_schedule`, `join_schedules`) equal
  optax's at every count, bit for bit, as `train()` builds them, and the
  optimizer under a schedule equals optax's MultiSteps(chain(clip, adamw(
  schedule))): the first update under warmup applies lr 0;
- both trainers' `train()` over 3 examples × 2 epochs (accumulation 2, so 3
  updates), with `engine.generate` replaced by the fixed completions of
  tests/test_torch_trainer.py and `prepare_requests` by fixed requests:
  the parameters after each update, the logs, the checkpoint directories,
  the tensorboard scalars, the wandb offline file and the debug reward log;
- `max_steps`, the one-batch-ahead prefetch on a worker thread, and a worker
  error that reaches the caller;
- resume: a run of one epoch saved with save_only_model=False and resumed
  for a second equals an uninterrupted two-epoch run bit for bit (constant
  lr); with the linear schedule the port keeps the restored optimizer state
  where JAX's `train()` re-initializes it (ROADMAP §C).

Tolerances: the schedules and the resume exact; the parameters 2e-6
absolute per AdamW update applied (tests/test_torch_trainer.py's bound
after one update, which grows by at most that much with each); the logs'
metrics 2e-4 as in tests/test_torch_trainer.py."""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_trainer import EXAMPLE, Processor, _completions, _request, spread_reward
from time_r1_tpu.rl import GRPOTrainer as JaxTrainer
from time_r1_tpu.rl import TrainConfig as JaxTrainConfig
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.utils.rewards import REWARD_FUNCS_REGISTRY as JAX_REWARDS
from time_r1_tpu_torch.models.qwen25vl import params_to_jax
from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
from time_r1_tpu_torch.rl.optim import AdamWMultiSteps, join_schedules, linear_schedule
from time_r1_tpu_torch.sampler import Request
from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

torch.set_num_threads(2)

G = 4
N_EXAMPLES = 3


def _schedules(lr, total, warmup):
    """train()'s schedule in both packages (time_r1_tpu/rl/trainer.py:1041-1054)."""
    if warmup:
        want = optax.join_schedules([optax.linear_schedule(0.0, lr, max(warmup, 1)),
                                     optax.linear_schedule(lr, 0.0, max(total - warmup, 1))], boundaries=[warmup])
        got = join_schedules([linear_schedule(0.0, lr, max(warmup, 1)),
                              linear_schedule(lr, 0.0, max(total - warmup, 1))], boundaries=[warmup])
    else:
        want, got = optax.linear_schedule(lr, 0.0, total), linear_schedule(lr, 0.0, total)
    return got, want


@pytest.mark.parametrize("lr,total,warmup", [(1e-6, 4, 0), (1e-6, 4, 2), (3e-4, 10, 3), (1e-3, 1, 0),
                                             (7e-6, 7, 1), (1e-6, 250, 25)])
def test_schedules_match_optax(lr, total, warmup):
    got, want = _schedules(lr, total, warmup)
    for count in range(total + 3):
        assert np.float32(got(count)) == np.float32(want(count)), count


def test_scheduled_optimizer_matches_optax():
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    got_sched, want_sched = _schedules(1e-2, 3, 1)
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0),
                                      optax.adamw(want_sched, weight_decay=0.01)), every_k_schedule=2)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = AdamWMultiSteps(got_sched, weight_decay=0.01, max_grad_norm=1.0, every_k=2)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for step in range(6):
        g = [(rng.normal(size=s) * 3).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, [torch.from_numpy(x) for x in g], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        if step == 1:  # the first update, under warmup, applied lr 0
            assert opt.lrs == [0.0] and all(np.array_equal(a.numpy(), p) for a, p in zip(tp, params))
    assert opt.lrs == [got_sched(n) for n in range(3)] and tstate.count == 3


def _requests():
    ids, patches = _request(np.random.default_rng(3))
    return ids, patches


def _examples():
    return [dict(EXAMPLE, problem=f"event {i}", solution=(1.0 + i, 2.5 + i)) for i in range(N_EXAMPLES)]


def _config(cls, out, **kw):
    base = dict(num_generations=G, max_completion_length=8, learning_rate=1e-3, adam_epsilon=1e-4, beta=0.04,
                num_train_epochs=2, gradient_accumulation_steps=2, save_steps=1, output_dir=str(out),
                report_to="none", warmup_ratio=0.5)
    base.update(kw)
    return cls(**base)


def _port_trainer(out, params=None, **kw):
    jp = jax_params()
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], spread_reward]
    tr = GRPOTrainer(port_params(jp) if params is None else params, CFG, Processor(), rewards,
                     config=_config(TrainConfig, out, **kw), ref_params=port_params(jax.tree.map(lambda x: x * 0.9, jp)),
                     dtype=torch.float32, device="cpu")
    comps = _completions(G)
    ids, patches = _requests()
    tr.engine.generate = lambda reqs, sp: [list(c) for c in comps] * len(reqs)
    tr.prepare_requests = lambda examples: [Request(ids, patches, (2, 4, 4), 1.0) for _ in examples]
    return tr


def _jax_trainer(out, **kw):
    jp = jax_params()
    rewards = [JAX_REWARDS["iou"], JAX_REWARDS["format"], spread_reward]
    tr = JaxTrainer(jp, JCFG, Processor(), rewards, config=_config(JaxTrainConfig, out, **kw),
                    ref_params=jax.tree.map(lambda x: x * 0.9, jp), dtype=jnp.float32)
    comps = _completions(G)
    ids, patches = _requests()
    tr.engine.generate = lambda reqs, sp: [list(c) for c in comps] * len(reqs)
    tr.prepare_requests = lambda examples: [JaxRequest(ids, patches, (2, 4, 4), 1.0) for _ in examples]
    return tr


def _snapshots(tr, to_tree):
    """Record the params after every applied update (every 2nd micro-step)."""
    snaps, step_batch = [], tr.step_batch

    def recorded(examples, requests=None):
        out = step_batch(examples, requests=requests)
        if tr.global_step % 2 == 0:
            snaps.append(to_tree())
        return out

    tr.step_batch = recorded
    return snaps


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """train() of both trainers with the sinks and the debug reward log on."""
    root = tmp_path_factory.mktemp("train_loop")
    runs = {}
    for name in ("jax", "port"):
        out = root / name
        kw = dict(report_to="tensorboard,wandb", logging_dir=str(out / "logs"))
        os.environ.update(DEBUG_MODE="true", LOG_PATH=str(out / "debug.log"))
        try:
            if name == "jax":
                tr = _jax_trainer(out, **kw)
                snaps = _snapshots(tr, lambda: jax.tree.map(np.asarray, tr.params))
            else:
                tr = _port_trainer(out, **kw)
                snaps = _snapshots(tr, lambda: jax.tree.map(np.copy, params_to_jax(tr.params, CFG)))
            logs = []
            tr.train(_examples(), log_fn=logs.append)
            tr._tb.close()
        finally:
            del os.environ["DEBUG_MODE"], os.environ["LOG_PATH"]
        runs[name] = dict(out=out, trainer=tr, snaps=snaps, logs=logs)
    return runs


def test_train_params_after_each_update_match_jax(both_runs):
    j, t = both_runs["jax"], both_runs["port"]
    assert len(j["snaps"]) == len(t["snaps"]) == 3  # 6 micro-steps, accumulation 2
    before = params_to_jax(port_params(jax_params()), CFG)
    for n, (a, b) in enumerate(zip(j["snaps"], t["snaps"]), start=1):
        moved = 0
        for (path, x), (_, y), (_, y0) in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                              jax.tree_util.tree_flatten_with_path(b)[0],
                                              jax.tree_util.tree_flatten_with_path(before)[0]):
            np.testing.assert_allclose(y - y0, x - y0, atol=2e-6 * n, rtol=0,
                                       err_msg=f"update {n} {jax.tree_util.keystr(path)}")
            moved += int(np.abs(y - y0).max() > 0)
        assert moved > 0 or n == 1  # the first update runs under warmup at lr 0
    assert t["trainer"].optimizer.lrs[0] == 0.0 and t["trainer"].optimizer.lrs[1] > 0
    assert t["trainer"].global_step == j["trainer"].global_step == 2 * N_EXAMPLES


def test_train_logs_match_jax(both_runs):
    jl, tl = both_runs["jax"]["logs"], both_runs["port"]["logs"]
    assert [(x["epoch"], x["step"]) for x in tl] == [(x["epoch"], x["step"]) for x in jl]
    assert len(tl) == 2 * N_EXAMPLES
    for a, b in zip(jl, tl):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=2e-5, err_msg=k)


def test_train_checkpoint_directories_match_jax(both_runs):
    def dirs(out):
        return sorted(d for d in os.listdir(out) if d.startswith(("checkpoint-", "epoch-")))

    want = dirs(both_runs["jax"]["out"])
    assert dirs(both_runs["port"]["out"]) == want
    assert want == ["checkpoint-1", "checkpoint-2", "checkpoint-3", "epoch-1", "epoch-2"]
    for d in want:
        with open(both_runs["jax"]["out"] / d / "trainer_state.json") as f, \
                open(both_runs["port"]["out"] / d / "trainer_state.json") as g:
            assert json.load(f) == json.load(g)
        with open(both_runs["jax"]["out"] / d / "README.md") as f, open(both_runs["port"]["out"] / d / "README.md") as g:
            assert f.read() == g.read()


def _tb_scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_sinks_write_what_jax_writes(both_runs):
    j, t = both_runs["jax"]["out"] / "logs", both_runs["port"]["out"] / "logs"
    want, got = _tb_scalars(j), _tb_scalars(t)
    assert set(got) == set(want) and "reward" in got
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]], rtol=2e-4, atol=2e-5,
                                   err_msg=tag)
    jw = [json.loads(x) for x in open(j / "wandb" / "offline-run.jsonl")]
    tw = [json.loads(x) for x in open(t / "wandb" / "offline-run.jsonl")]
    assert [sorted(x) for x in tw] == [sorted(x) for x in jw] and len(tw) == 2 * N_EXAMPLES
    for a, b in zip(jw, tw):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=2e-5, err_msg=k)


def test_debug_reward_log_matches_jax(both_runs):
    def lines(out):  # the timestamps differ
        return [ln.split(" ")[0] if ln.startswith("-------------") else ln
                for ln in open(out / "debug.log").read().splitlines()]

    want = lines(both_runs["jax"]["out"])
    assert lines(both_runs["port"]["out"]) == want and len(want) == 4 * G * 2 * N_EXAMPLES


def test_max_steps_stops_the_loop(tmp_path):
    tr = _port_trainer(tmp_path, report_to="none")
    tr.train(_examples(), log_fn=lambda logs: None, max_steps=2)
    assert tr.global_step == 2 and tr.opt_state.count == 1
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-1"]


def test_prefetch_prepares_one_batch_ahead_on_a_worker(tmp_path):
    """Batch k+1's requests are prepared on a worker thread while step k
    runs (step k waits until they are), and each step gets its own batch's
    requests."""
    tr = _port_trainer(tmp_path, report_to="none", num_train_epochs=1, save_steps=100)
    prepared = {f"event {i}": threading.Event() for i in range(N_EXAMPLES)}
    threads, prepare, step_batch = [], tr.prepare_requests, tr.step_batch

    def prepare_logged(examples):
        threads.append(threading.current_thread() is threading.main_thread())
        out = prepare(examples)
        prepared[examples[0]["problem"]].set()
        return out

    def step_logged(examples, requests=None):
        assert requests is not None and len(requests) == len(examples)
        i = int(examples[0]["problem"].split()[-1])
        if i + 1 < N_EXAMPLES:  # the next batch is prepared during this step
            assert prepared[f"event {i + 1}"].wait(timeout=60)
        return step_batch(examples, requests=requests)

    tr.prepare_requests, tr.step_batch = prepare_logged, step_logged
    tr.train(_examples(), log_fn=lambda logs: None)
    assert threads == [False] * N_EXAMPLES  # never on the main thread
    assert tr.global_step == N_EXAMPLES and "host_preproc_wait" in tr.timers.summary()


def test_prefetch_error_reaches_the_caller(tmp_path):
    tr = _port_trainer(tmp_path, report_to="none", num_train_epochs=1)
    prepare = tr.prepare_requests

    def failing(examples):
        if examples[0]["problem"] == "event 1":
            raise RuntimeError("the decoder failed on event 1")
        return prepare(examples)

    tr.prepare_requests = failing
    with pytest.raises(RuntimeError, match="event 1"):
        tr.train(_examples(), log_fn=lambda logs: None)
    assert tr.global_step == 1


def _flat(tr):
    out = [p.detach().clone() for p in jax.tree.leaves(tr.params)]
    st = tr.opt_state
    return out + [t.clone() for t in st.mu + st.nu + st.acc] + [torch.tensor([st.count, st.mini_step])]


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Constant lr: one epoch, saved with the optimizer state, then resumed
    for the second (the CLI's max_steps), equals two epochs in one run."""
    whole = _port_trainer(tmp_path / "whole", report_to="none", lr_scheduler_type="constant", save_steps=100)
    whole.train(_examples(), log_fn=lambda logs: None)

    first = _port_trainer(tmp_path / "first", report_to="none", lr_scheduler_type="constant", save_steps=100,
                          num_train_epochs=1, save_only_model=False)
    first.train(_examples(), log_fn=lambda logs: None)
    first.save_checkpoint(str(tmp_path / "first"))
    assert first.opt_state.mini_step == 1  # the accumulation window spans the epoch boundary

    resumed = _port_trainer(tmp_path / "second", report_to="none", lr_scheduler_type="constant", save_steps=100,
                            num_train_epochs=1)
    resumed.load_checkpoint_state(str(tmp_path / "first"))
    assert resumed.global_step == N_EXAMPLES
    resumed.train(_examples(), log_fn=lambda logs: None, max_steps=2 * N_EXAMPLES)
    assert resumed.global_step == whole.global_step == 2 * N_EXAMPLES
    for a, b in zip(_flat(resumed), _flat(whole)):
        assert torch.equal(a, b)


def test_resume_keeps_the_optimizer_state_jax_drops_it(tmp_path):
    """ROADMAP §C: under the linear schedule JAX's train() rebuilds its
    optimizer and re-initializes the state load_checkpoint_state restored;
    the port's keeps the moments, Adam's count and the accumulation, and
    starts only the schedule over. The same resumed run then ends with
    different weights."""
    port = _port_trainer(tmp_path / "p", report_to="none", num_train_epochs=1, save_steps=100,
                         save_only_model=False)
    port.train(_examples(), log_fn=lambda logs: None)
    port.save_checkpoint(str(tmp_path / "p"))
    saved_mu = [m.clone() for m in port.opt_state.mu]

    jtr = _jax_trainer(tmp_path / "j", num_train_epochs=1, save_steps=100)
    jtr.train(_examples(), log_fn=lambda logs: None)

    port2 = _port_trainer(tmp_path / "p2", report_to="none", num_train_epochs=1, save_steps=100)
    port2.load_checkpoint_state(str(tmp_path / "p"))
    assert port2.opt_state.count == 1 and port2.opt_state.mini_step == 1
    assert all(torch.equal(a, b) for a, b in zip(port2.opt_state.mu, saved_mu))
    # the JAX trainer resumed with its first run's state in memory (its orbax
    # restore of opt_state fails with this orbax version: ROADMAP §C)
    jtr2 = _jax_trainer(tmp_path / "j2", num_train_epochs=1, save_steps=100)
    jtr2.params, jtr2.opt_state, jtr2.global_step = jtr.params, jtr.opt_state, jtr.global_step
    assert int(jtr2.opt_state.gradient_step) == 1 and int(jtr2.opt_state.mini_step) == 1  # restored...

    port2.train(_examples(), log_fn=lambda logs: None, max_steps=2 * N_EXAMPLES)
    jtr2.train(_examples(), log_fn=lambda logs: None, max_steps=2 * N_EXAMPLES)
    # ... then dropped by JAX's train(): it counts only the resumed run's update
    assert int(jtr2.opt_state.gradient_step) == 1 and port2.opt_state.count == 3
    diff = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(params_to_jax(port2.params, CFG)),
                                                           jax.tree.leaves(jax.tree.map(np.asarray, jtr2.params))))
    assert diff > 1e-4, diff
