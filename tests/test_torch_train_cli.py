"""The port's `python -m time_r1_tpu_torch.cli.train` against the JAX
package's `cli/train.py`, on the CPU:

- both parsers have the same dests and defaults, and `--help` works;
- `load_json_dataset_tg` gives the JAX package's examples (missing videos
  dropped, sentences normalized, the seeded shuffle or the curriculum
  order);
- `main` end to end on the tiny config, on a clip written with OpenCV
  (tests/test_torch_video.py::write_clip) through the port's own decoder,
  with `Qwen25VLProcessor.from_pretrained` patched to the tiny tokenizer's
  processor, as the JAX package's CLI tests patch it: from an HF checkpoint
  (`save_hf_checkpoint` + config.json), with the default remat, writing the
  checkpoints of its save cadence and a final one that reloads equal to the
  trained weights; then from that native checkpoint with
  `--resume_from_checkpoint`, which restores params, optimizer state and
  global_step and stops at resumed + quota;
- `--use_peft true` over a bf16 base and with `--train_base_quantization
  int8 --rollout_quantization int8` (one load, the int8 fused base, the
  adapters trained, the checkpoint with `lora_adapters.npz`), and
  `--train_base_quantization` without `--use_peft` refused;
- the entry point runs on the card unless asked for the CPU (its
  `--tensor_parallel_size 2` run is in tests/test_torch_sharded_trainer.py)."""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from test_torch_bridge import CFG, REPO, jax_params, port_params
from test_torch_video import write_clip
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu.cli import train as jax_cli
from time_r1_tpu_torch.cli import train as cli
from time_r1_tpu_torch.models.qwen25vl import convert as conv
from time_r1_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(2)

REQUIRED = ["--model_name_or_path", "m", "--output_dir", "o", "--train_data_path", "d.json"]


def test_parsers_match_jax():
    got, want = vars(cli.get_args(REQUIRED)), vars(jax_cli.get_args(REQUIRED))
    assert got == want
    assert got["gradient_checkpointing"] is True and got["remat_policy"] == "full"


def test_help_runs():
    out = subprocess.run([sys.executable, "-m", "time_r1_tpu_torch.cli.train", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--gradient_checkpointing" in out.stdout and "--resume_from_checkpoint" in out.stdout


def _annotations(tmp_path, videos):
    items = [
        {"video": videos[0], "duration": 4.0, "timestamp": [0.5, 2.0], "sentence": " A person Sits down. "},
        {"video": str(tmp_path / "missing.mp4"), "duration": 4.0, "timestamp": [1, 2], "sentence": "gone"},
        {"video": videos[1], "duration": 4.0, "timestamp": [1.0, 3.0], "sentence": "the door opens",
         "video_start": 0.5, "video_end": 3.5},
        {"video": videos[0], "duration": 4.0, "timestamp": [2, 3.5], "sentence": "Someone waves."},
    ]
    path = tmp_path / "train.json"
    path.write_text(json.dumps(items))
    return str(path)


@pytest.mark.parametrize("curriculum", [False, True])
def test_load_json_dataset_tg_matches_jax(tmp_path, curriculum):
    videos = []
    for name in ("a.mp4", "b.mp4"):
        (tmp_path / name).write_bytes(b"placeholder")
        videos.append(str(tmp_path / name))
    path = _annotations(tmp_path, videos)
    random.seed(42)
    got = cli.load_json_dataset_tg(path, curriculum)
    random.seed(42)
    want = jax_cli.load_json_dataset_tg(path, curriculum)
    assert got == want and len(got) == 3
    assert {e["problem"] for e in got} == {"a person sits down", "the door opens", "someone waves"}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_clips")
    return [write_clip(d / "a.mp4", seed=0), write_clip(d / "b.mp4", seed=1)]


@pytest.fixture()
def tiny_processor(monkeypatch):
    processor = cli.Qwen25VLProcessor(TinyTokenizer(), pad_token_id=CFG.pad_token_id, eos_token_id=CFG.eos_token_id)
    monkeypatch.setattr(cli.Qwen25VLProcessor, "from_pretrained", classmethod(lambda cls, path, **kw: processor))


def _hf_checkpoint(path):
    conv.save_hf_checkpoint(str(path), port_params(jax_params()), CFG)
    # the tiny config's pad id 0 reads back as HF's 151643 (out of its vocabulary): give it one in range
    (path / "config.json").write_text(json.dumps({**conv.config_to_hf_dict(CFG), "pad_token_id": 2}))
    return str(path)


def _args(ckpt, out, data, *extra):
    return cli.get_args(["--model_name_or_path", ckpt, "--output_dir", str(out), "--train_data_path", data,
                         "--reward_funcs", "iou", "format", "--num_generations", "2",
                         "--max_completion_length", "4", "--num_train_epochs", "1", "--warmup_ratio", "0.5",
                         "--learning_rate", "1e-3", "--save_steps", "1", "--report_to", "none",
                         "--total_pixels", str(8 * 28 * 28), "--video_min_pixels", str(4 * 28 * 28), *extra])


def _trained_leaves(trainer):
    return [p.detach().clone() for p in jax.tree.leaves(trainer.params)]


def test_main_from_hf_then_resume_from_native(tmp_path, clips, tiny_processor, capsys):
    data = _annotations(tmp_path, clips)
    hf = _hf_checkpoint(tmp_path / "hf")
    first = cli.main(_args(hf, tmp_path / "run1", data, "--save_only_model", "false"), device="cpu")
    assert first.hp.gradient_checkpointing == "full"  # the CLI's default remat
    assert first.global_step == 3 and first.opt_state.count == 1 and first.opt_state.mini_step == 1
    assert first.optimizer.lrs == [0.0]  # warmup: the first update applies lr 0
    out1 = tmp_path / "run1"
    assert sorted(d for d in os.listdir(out1) if d.startswith(("checkpoint", "epoch"))) == ["checkpoint-1", "epoch-1"]
    assert json.loads((out1 / "trainer_state.json").read_text()) == {"global_step": 3}
    assert ck.is_native_checkpoint(str(out1), "opt_state")
    reloaded, cfg = conv.load_checkpoint(str(out1), device="cpu")
    assert cfg == first.cfg and cfg.pad_token_id == 2
    for a, b in zip(jax.tree.leaves(reloaded), _trained_leaves(first)):
        assert torch.equal(a, b)

    resumed = cli.main(_args(str(out1), tmp_path / "run2", data, "--resume_from_checkpoint", str(out1)),
                       device="cpu")
    assert "Resuming from step 3; will stop at 6" in capsys.readouterr().out
    # micro-step 4 closes the restored accumulation window, 6 the next one
    assert resumed.global_step == 6 and resumed.opt_state.count == 3 and resumed.opt_state.mini_step == 0
    assert resumed.optimizer.lrs == [0.0, float(np.float32(first.c.learning_rate))]  # the schedule starts over
    assert json.loads((tmp_path / "run2" / "trainer_state.json").read_text()) == {"global_step": 6}


def test_base_quantization_needs_peft():
    """The JAX CLI's exit, before anything is loaded."""
    with pytest.raises(SystemExit, match="--train_base_quantization requires --use_peft true"):
        cli.main(cli.get_args([*REQUIRED, "--train_base_quantization", "int8"]), device="cpu")


@pytest.mark.parametrize("quant", ["int8", ""], ids=["int8_base", "bf16_base"])
def test_main_with_peft(tmp_path, clips, tiny_processor, monkeypatch, quant):
    """`--use_peft true` (with `--train_base_quantization int8
    --rollout_quantization int8`: the single-card 7B flags) at 2 layers: one
    load (the base is the reference), the int8 base in the fused layout, the
    adapters updated while the base stays as loaded, and a final checkpoint
    of the int8 base (or the merged model) with `lora_adapters.npz`, both
    reading back equal."""
    from time_r1_tpu_torch.rl.lora import lora_leaves

    loads = []
    real_load = cli.load_checkpoint
    monkeypatch.setattr(cli, "load_checkpoint", lambda *a, **kw: loads.append(a) or real_load(*a, **kw))
    # rewards that vary within a group, so that the advantages and the adapters' gradients are not zero
    monkeypatch.setitem(cli.REWARD_FUNCS_REGISTRY, "format", lambda completions, **kw: [
        float(i) for i in range(len(completions))])
    data = _annotations(tmp_path, clips)
    extra = ["--use_peft", "true", "--lora_r", "4", "--lora_alpha", "8", "--beta", "0.04", "--warmup_ratio", "0"]
    if quant:
        extra += ["--train_base_quantization", "int8", "--rollout_quantization", "int8"]
    tr = cli.main(_args(_hf_checkpoint(tmp_path / "hf"), tmp_path / "run", data, *extra), device="cpu")
    assert len(loads) == 1 and tr.ref_params is tr.params and tr.lora_cfg.scaling == 2.0
    lp = tr.params["text"]["layers"][0]
    assert ("qkv" in lp and lp["qkv"]["q8"].dtype == torch.int8) == bool(quant)
    assert tr.global_step == 3 and tr.opt_state.count == 1
    assert any(float(b.detach().abs().max()) > 0 for b in lora_leaves(tr.lora)[1::2])  # B moved off 0
    if quant:
        assert tr.engine.params is tr.params and tr.engine.lora_side is not None
    saved, _ = conv.load_checkpoint(str(tmp_path / "run"), dtype=torch.bfloat16, device="cpu")
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(tr._policy_params())):
        assert torch.equal(a, b)
    got = conv.load_lora_npz(str(tmp_path / "run" / conv.LORA_FILE))
    want = conv.lora_to_jax(tr.lora, tr.cfg)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k][n], want[k][n]) for k in want for n in ("lora_a", "lora_b"))


def test_main_runs_on_the_card_unless_asked(tmp_path, clips, tiny_processor):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    data = _annotations(tmp_path, clips)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_args(_hf_checkpoint(tmp_path / "hf"), tmp_path / "run", data))
