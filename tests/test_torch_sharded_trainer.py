"""The sharded trainer (FSDP over "data", TP over "model") over gloo ranks
(`test_torch_ring_attention.spawn_ranks`):

- four ranks on a 2×2 mesh: `GRPOTrainer(mesh=...).train()` over two
  examples (each data rank its own, both model ranks of a data group the
  same) against one process's `train()` over both (the loss and gathered
  metrics 2e-4 relative, the gathered weights 2e-6 absolute at lr 1e-3 and
  eps 1e-4, as tests/test_torch_multiprocess_dp.py); every rank of a model
  group trained on bit-equal rows (the rows the loss saw, recorded on each
  rank: model-rank 0 rolls out and broadcasts); every rank's gathered
  weights bit-equal; the checkpoint written once;
- on the same mesh, with the optimizer state offloaded and accumulation 2, a
  save after the first `step_batch` (`save_only_model` false: params and the
  sharded optimizer state gathered to rank 0) and a resume into a fresh
  trainer, whose second step equals the uninterrupted run's bit for bit;
- the refusals by name (A13): a model dim that would split a head (1×4 over
  the tiny config's 2 vision heads, and the 7B's 28 q heads at tp 8: a model
  dim that is a multiple of the kv heads is taken, each kv head replicated,
  `tests/test_torch_kv_replication.py`) and a quantized base with model > 1
  (use_peft and context parallelism with model > 1 train:
  `tests/test_torch_lora_tp.py`, `tests/test_torch_cp_tp.py`);
- two ranks with `--tensor_parallel_size 2`: `cli.train.main` from an HF
  checkpoint over clips the port's decoder reads, and `cli.finetune.main`
  over `cli.preprocess_videos`' npz files: the ranks' gathered weights
  equal, and the final checkpoint (written once) reloads equal to them.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_multiprocess_dp import EXAMPLES, _leaf_list, _trainer
from test_torch_ring_attention import spawn_ranks


def _recording():
    """Record every loss batch the trainer builds (in this rank's process)."""
    from time_r1_tpu_torch.rl import trainer as trainer_mod

    rows = []
    build = trainer_mod.build_grpo_split_batch

    def recorded(*args, **kwargs):
        batch = build(*args, **kwargs)
        rows.append([t.clone() for t in (batch.prompt_ids, batch.comp_ids, batch.comp_mask, batch.advantages)])
        return batch

    trainer_mod.build_grpo_split_batch = recorded
    return rows, lambda: setattr(trainer_mod, "build_grpo_split_batch", build)


def _refusals(params, cfg) -> dict:
    """The A13 refusals' messages, a list for each case (None where nothing
    was raised)."""
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.ops.quant import quantize_params
    from time_r1_tpu_torch.parallel import make_mesh
    from time_r1_tpu_torch.parallel.tensor import check_heads

    out = {}
    cases = {
        "kv_heads": (make_mesh(4), {}, params),
        "quantized_base": (make_mesh(2), dict(use_peft=True), quantize_params(params, bits=8, fuse=False)),
    }
    for name, (mesh, kw, tree) in cases.items():
        try:
            _trainer(tree, None, cfg, "unused", mesh=mesh, **kw)
            out[name] = None
        except NotImplementedError as e:
            out[name] = [str(e)]
    try:  # the 7B's 28 q heads at tp 8 (its 4 kv heads alone would be replicated)
        check_heads(Qwen25VLConfig.qwen25vl_7b(), 8)
        out["kv_heads"] = None
    except NotImplementedError as e:
        out["kv_heads"] = None if out["kv_heads"] is None else out["kv_heads"] + [str(e)]
    return out


def _worker4(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import make_mesh, maybe_init_distributed

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh(2)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    tr = _trainer(payload["params"], payload["ref_params"], cfg, os.path.join(workdir, "train"), mesh=mesh)
    rows, stop = _recording()
    logs = []
    tr.train(EXAMPLES, log_fn=logs.append)
    stop()
    out["train"] = dict(logs=logs, params=_leaf_list(tr.gathered_params()), rows=rows, steps=tr.global_step,
                        saved=sorted(os.listdir(os.path.join(workdir, "train"))), rolls_out=tr._rolls_out)

    d = mesh.get_local_rank("data")
    kw = dict(gradient_accumulation_steps=2, save_only_model=False, offload_optimizer=True)
    ckpt = os.path.join(workdir, "resume_ckpt")
    whole = _trainer(payload["params"], payload["ref_params"], cfg, os.path.join(workdir, "whole"), mesh=mesh, **kw)
    whole.step_batch([EXAMPLES[d]])
    whole.save_checkpoint(ckpt)
    whole.step_batch([EXAMPLES[d]])
    resumed = _trainer(payload["params"], payload["ref_params"], cfg, os.path.join(workdir, "resumed"), mesh=mesh,
                       **kw)
    resumed.load_checkpoint_state(ckpt)
    restored = (resumed.global_step, resumed.opt_state.count, resumed.opt_state.mini_step)
    resumed.step_batch([EXAMPLES[d]])
    out["resume"] = dict(whole=_leaf_list(whole.gathered_params()), resumed=_leaf_list(resumed.gathered_params()),
                         restored=restored, counts=(resumed.opt_state.count, whole.opt_state.count),
                         first=_leaf_list(payload["params"]))
    out["refusals"] = _refusals(payload["params"], cfg)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _worker2(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from time_r1_tpu_torch.cli import finetune
    from time_r1_tpu_torch.cli import train as cli
    from tiny_tokenizer import TinyTokenizer

    torch.set_num_threads(1)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg_ids = payload["ids"]
    processor = cli.Qwen25VLProcessor(TinyTokenizer(), pad_token_id=cfg_ids["pad"], eos_token_id=cfg_ids["eos"])
    cli.Qwen25VLProcessor.from_pretrained = classmethod(lambda cls, path, **kw: processor)
    out = {}
    tr = cli.main(cli.get_args(payload["train_argv"]), device="cpu")
    out["train"] = dict(params=_leaf_list(tr.gathered_params()), steps=tr.global_step, tp=tr.tp,
                        rolls_out=tr._rolls_out, sharded=tr.shard is not None)
    ft = finetune.main(payload["finetune_argv"], device="cpu")
    out["finetune"] = dict(params=_leaf_list(ft.gathered_params()), steps=ft.global_step, tp=ft.tp)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    import jax

    from test_torch_bridge import VOCAB, jax_params, port_params

    jp = jax_params()
    jref = {**jp, "text": jax.tree.map(lambda x: x * 0.9, jp["text"])}
    workdir = tmp_path_factory.mktemp("sharded4")
    torch.save(dict(vocab=VOCAB, params=port_params(jp), ref_params=port_params(jref)),
               os.path.join(workdir, "payload.pt"))
    return jp, jref, spawn_ranks("test_torch_sharded_trainer", "_worker4", 4, workdir)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    from test_torch_bridge import CFG
    from test_torch_finetune import _charades
    from test_torch_train_cli import _annotations, _hf_checkpoint
    from test_torch_video import write_clip
    from time_r1_tpu_torch.cli import preprocess_videos as pre

    workdir = tmp_path_factory.mktemp("sharded2")
    clips = [write_clip(workdir / "a.mp4", seed=0), write_clip(workdir / "b.mp4", seed=1)]
    hf = _hf_checkpoint(workdir / "hf")
    common = ["--reward_funcs", "iou", "format", "--num_generations", "2", "--max_completion_length", "4",
              "--num_train_epochs", "1", "--learning_rate", "1e-3", "--report_to", "none",
              "--tensor_parallel_size", "2"]
    train_argv = ["--model_name_or_path", hf, "--output_dir", str(workdir / "train_out"), "--train_data_path",
                  _annotations(workdir, clips), "--save_steps", "1", "--total_pixels", str(8 * 28 * 28),
                  "--video_min_pixels", str(4 * 28 * 28), *common]
    folder = workdir / "videos"
    folder.mkdir()
    for name, clip in zip(("vid_a", "vid_b"), clips):
        os.symlink(clip, folder / f"{name}.mp4")
    ann = _charades(workdir)
    pp = workdir / "pre"
    pre.main(["--train_data_path", ann, "--video_folder", str(folder), "--output_dir", str(pp),
              "--max_pix_size", "8", "--min_pix_size", "4", "--num_workers", "1"])
    finetune_argv = ["--model_name_or_path", hf, "--output_dir", str(workdir / "finetune_out"),
                     "--train_data_path", ann, "--video_folder", str(folder), "--preprocessed_data_path", str(pp),
                     "--beta", "0.0", "--use_grpo", "false", *common]
    torch.save(dict(ids=dict(pad=CFG.pad_token_id, eos=CFG.eos_token_id), train_argv=train_argv,
                    finetune_argv=finetune_argv), os.path.join(workdir, "payload.pt"))
    return workdir, spawn_ranks("test_torch_sharded_trainer", "_worker2", 2, workdir)


def test_2x2_train_matches_one_process(four, tmp_path):
    from test_torch_bridge import CFG, port_params

    jp, jref, results = four
    runs = [r["train"] for r in results]
    assert [r["coords"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["rolls_out"] for r in runs] == [True, False, True, False]
    assert all(r["steps"] == 1 for r in runs) and runs[0]["saved"] == ["epoch-1"]
    for r in runs[1:]:
        assert r["logs"] == runs[0]["logs"]
        for a, b in zip(r["params"], runs[0]["params"]):
            assert torch.equal(a, b)
    one = _trainer(port_params(jp), port_params(jref), CFG, str(tmp_path), per_device_train_batch_size=2)
    logs = []
    one.train(EXAMPLES, log_fn=logs.append)
    (want,), (got,) = logs, runs[0]["logs"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=2e-4, abs=2e-5), k
    for a, b in zip(runs[0]["params"], _leaf_list(one.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)


def test_every_model_rank_trains_on_the_same_rows(four):
    runs = [r["train"]["rows"] for r in four[2]]
    for d in (0, 1):  # ranks 2d and 2d + 1 form data rank d's model group
        a, b = runs[2 * d], runs[2 * d + 1]
        assert len(a) == len(b) == 1
        for x, y in zip(a[0], b[0]):
            assert torch.equal(x, y)
    assert not torch.equal(runs[0][0][0], runs[2][0][0])  # the data ranks trained on their own examples


def test_sharded_resume_equals_the_uninterrupted_run(four):
    for r in four[2]:
        res = r["resume"]
        assert res["restored"] == (1, 0, 1) and res["counts"] == (1, 1)
        for a, b in zip(res["whole"], res["resumed"]):
            assert torch.equal(a, b)
        assert max(float((a - b).abs().max()) for a, b in zip(res["whole"], res["first"])) > 0


@pytest.mark.parametrize("case,match", [("kv_heads", "does not divide num_attention_heads"),
                                        ("quantized_base", "cannot TP-split")])
def test_refusals_name_a13(four, case, match):
    for r in four[2]:
        msgs = r["refusals"][case]
        assert msgs is not None and all("A13" in msg and match in msg for msg in msgs)
    if case == "kv_heads":  # the tiny config's 2 vision heads at tp 4, the 7B's 28 q heads at tp 8
        assert [m.split(" does")[0] for m in four[2][0]["refusals"][case]] == ["tensor_parallel_size=4",
                                                                                "tensor_parallel_size=8"]


@pytest.mark.parametrize("entry", ["train", "finetune"])
def test_clis_train_with_tensor_parallel_size_2(two, entry):
    from time_r1_tpu_torch.models.qwen25vl import convert as conv
    from time_r1_tpu_torch.rl.grpo import _leaves

    workdir, results = two
    r0, r1 = results[0][entry], results[1][entry]
    assert r0["tp"] == r1["tp"] == 2 and r0["steps"] == r1["steps"] == 3
    if entry == "train":
        assert r0["sharded"] and r0["rolls_out"] and not r1["rolls_out"]
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)
    out = workdir / f"{entry}_out"
    assert json.loads((out / "trainer_state.json").read_text()) == {"global_step": 3}
    saved, _ = conv.load_checkpoint(str(out), device="cpu")
    for a, b in zip(_leaves(saved), r0["params"]):
        assert torch.equal(a, b)
