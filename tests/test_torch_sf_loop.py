"""The port's TimeRFT sample-filtering loop (`time_r1_tpu_torch/cli/train_sf.py`)
on the CPU, on the tiny config (weights from `params_from_jax`, f32 compute
where the entry points allow it) and clips written with OpenCV
(tests/test_torch_video.py::write_clip), through the real CLIs and the
port's own decoder:

- one round (train, the smallest checkpoint, self-eval, difficulty merge,
  filter) leaves the JAX package's artifact layout, with
  `Qwen25VLProcessor.from_pretrained` patched to the tiny tokenizer in both,
  as the JAX package's SF test patches it;
- two rounds hand over as the reference does: round 1 trains from round 0's
  smallest checkpoint on round 0's filtered json (a spy on
  `train.get_args`);
- checkpoints carry their tokenizer: with a `PreTrainedTokenizerFast` saved
  into the base checkpoint and nothing patched, round 0's checkpoint holds
  the tokenizer's files, and round 0's evaluate and round 1's train load
  them; the JAX package's `save_checkpoint` writes none, so
  `from_pretrained` fails on its directory (ROADMAP §C)."""

import json
import os

import pytest
import torch

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_video import jax_native_libs, write_clip
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu_torch.cli import train as train_cli
from time_r1_tpu_torch.cli import train_sf
from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
from time_r1_tpu_torch.models.qwen25vl.convert import NATIVE_CONFIG, config_to_plain_dict
from time_r1_tpu_torch.utils.checkpoint import save_params

torch.set_num_threads(2)

PIXELS = str(8 * 28 * 28)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    jax_native_libs()
    d = tmp_path_factory.mktemp("sf_clips")
    return [write_clip(d / "a.mp4", seed=0), write_clip(d / "b.mp4", frames=16, fps=4.0, seed=1)]


def _annotations(path, clips):
    ann = [
        {"video": clips[0], "duration": 3.0, "timestamp": [0.5, 1.5], "sentence": "person sitting down in a chair",
         "qid": "tvg_0", "video_start": 0.0, "video_end": 2.0, "pred": None},
        {"video": clips[1], "duration": 4.0, "timestamp": [1.0, 3.0], "sentence": "person stands up",
         "qid": "tvg_1", "video_start": 1.0, "video_end": 3.5, "pred": None},
    ]
    path.write_text(json.dumps(ann))
    return str(path)


def _port_base(path):
    save_params(str(path), port_params(jax_params()))
    (path / NATIVE_CONFIG).write_text(json.dumps(config_to_plain_dict(CFG)))
    return str(path)


def _tiny_processor(cls):
    return classmethod(lambda c, path, **kw: cls(TinyTokenizer(), pad_token_id=CFG.pad_token_id,
                                                 eos_token_id=CFG.eos_token_id))


def _sf_args(base, data, *extra):
    return ["--model_name_or_path", base, "--exp_dir", "exp", "--initial_data", data, "--k", "2",
            "--num_generations", "2", "--max_completion_length", "4", "--eval_max_new_tokens", "4",
            "--total_pixels", PIXELS, "--reward_funcs", "iou_v2", "format", *extra]


def _layout(root):
    """Every directory and file under root, relative, with checkpoint
    directories as leaves and the final weights as `params*` (each package
    writes its own format: params.safetensors, an orbax params/)."""
    out = set()
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        if os.path.basename(d).startswith(("checkpoint-", "epoch-")):
            dirs[:] = []
            out.add(rel + "/")
            continue
        if "params" in dirs or "params.safetensors" in files:
            out.add(os.path.join(rel, "params*"))
        # the metric sink's event files are named by host and time
        dirs[:] = [x for x in dirs if x not in ("tb", "params")]
        out.update(os.path.join(rel, f) for f in files if f != "params.safetensors" and not f.startswith("events.out"))
    return out


def _count_step(self, examples, requests=None):
    self.global_step += 1
    return {}


def test_one_round_same_layout_as_jax(tmp_path, clips, monkeypatch):
    from time_r1_tpu.cli import train_sf as jax_train_sf
    from time_r1_tpu.models.processor import Qwen25VLProcessor as JaxProcessor
    from time_r1_tpu.models.qwen25vl.convert import config_to_plain_dict as jax_plain
    from time_r1_tpu.rl.trainer import GRPOTrainer as JaxTrainer
    from time_r1_tpu.utils.checkpoint import save_params as jax_save_params

    monkeypatch.setattr(Qwen25VLProcessor, "from_pretrained", _tiny_processor(Qwen25VLProcessor))
    monkeypatch.setattr(JaxProcessor, "from_pretrained", _tiny_processor(JaxProcessor))
    # only the files the loop leaves are compared: JAX's step counts and does no work (its rollout, loss and
    # update are held against the port's in tests/test_torch_{grpo,trainer}.py), which saves its compile
    monkeypatch.setattr(JaxTrainer, "step_batch", _count_step)
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    port_root.mkdir()
    jax_root.mkdir()
    port_base = _port_base(port_root / "base_model")
    jax_base = jax_root / "base_model"
    jax_save_params(str(jax_base), jax_params(cfg=JCFG))
    (jax_base / "timer1_config.json").write_text(json.dumps(jax_plain(JCFG)))

    monkeypatch.chdir(port_root)
    last = train_sf.main(train_sf.get_args(_sf_args(port_base, _annotations(port_root / "train.json", clips),
                                                     "--rounds", "1")), device="cpu")
    monkeypatch.chdir(jax_root)
    jax_train_sf.main(jax_train_sf.get_args(_sf_args(str(jax_base), _annotations(jax_root / "train.json", clips),
                                                     "--rounds", "1")))
    got, want = _layout(port_root / "exp"), _layout(jax_root / "exp")
    assert got == want, (got - want, want - got)
    r0 = port_root / "exp" / "round_0"
    assert last == "exp/round_0/exp/round_0/filtering_epoch0/train_v4_cloud_0070_all.json"
    assert os.path.isfile(port_root / last)
    assert any(p.startswith("round_0/checkpoint-") for p in got)
    recs = [json.loads(line) for line in open(r0 / "filtering_epoch0" / "tg_0_1.jsonl")]
    assert [r["qid"] for r in recs] == ["tvg_0", "tvg_1"]
    merged = json.load(open(r0 / "exp" / "round_0" / "filtering_epoch0" / "train_v4_cloud.json"))
    assert [d["qid"] for d in merged] == ["tvg_0", "tvg_1"]
    assert all("difficulty" in d and "pred" in d for d in merged)


def test_two_rounds_handoff(tmp_path, clips, monkeypatch):
    """Round 1 trains FROM round 0's smallest checkpoint ON round 0's
    filtered json (difficulty and pred carried forward) and leaves its own
    artifacts. random_sample keeps the data whatever the tiny model's
    difficulties are."""
    monkeypatch.setattr(Qwen25VLProcessor, "from_pretrained", _tiny_processor(Qwen25VLProcessor))
    consumed = []
    real_get_args = train_cli.get_args

    def spy_get_args(argv=None):
        args = real_get_args(argv)
        consumed.append((args.train_data_path, args.model_name_or_path, args.num_train_epochs))
        return args

    monkeypatch.setattr(train_cli, "get_args", spy_get_args)
    monkeypatch.chdir(tmp_path)
    base = _port_base(tmp_path / "base_model")
    data = _annotations(tmp_path / "train.json", clips)
    train_sf.main(train_sf.get_args(_sf_args(base, data, "--rounds", "2", "--filter_task", "random_sample")),
                  device="cpu")

    r0, r1 = tmp_path / "exp" / "round_0", tmp_path / "exp" / "round_1"
    assert consumed[0] == (data, base, 5.0)
    r1_data, r1_model, r1_epochs = consumed[1]
    assert r1_model == train_sf.smallest_checkpoint("exp/round_0") and r1_epochs == 1.0
    assert (tmp_path / r1_model).is_dir()
    assert r1_data.endswith("_random.json")
    data1 = json.load(open(tmp_path / r1_data))
    assert {d["qid"] for d in data1} == {"tvg_0", "tvg_1"}
    assert all("difficulty" in d and "pred" in d for d in data1)
    assert any(d.startswith("checkpoint-") for d in os.listdir(r1))
    assert any(f.endswith(".jsonl") for f in os.listdir(r1 / "filtering_epoch1"))
    assert any(d.startswith("checkpoint-") for d in os.listdir(r0))


def test_smallest_checkpoint(tmp_path):
    for d in ("checkpoint-10", "checkpoint-2", "checkpoint-x", "epoch-1", "checkpoint-3"):
        (tmp_path / d).mkdir()
    assert train_sf.smallest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint-2")
    with pytest.raises(FileNotFoundError):
        train_sf.smallest_checkpoint(str(tmp_path / "epoch-1"))


def hf_tokenizer():
    """A PreTrainedTokenizerFast on the tiny config's ids, made here from the
    `tokenizers` library (no tokenizer files are in the repository): the
    specials at the tiny tokenizer's ids, printable ASCII one character a
    token at ids 3..97, anything else [UNK] (98), fillers up to the vocab."""
    from tokenizers import Regex, Tokenizer, decoders, pre_tokenizers
    from tokenizers.models import WordLevel
    from transformers import PreTrainedTokenizerFast

    specials = {**TinyTokenizer.SPECIALS, "<|endoftext|>": 0}
    vocab = {tok: i for tok, i in specials.items()}
    vocab.update({chr(c): c - 32 + 3 for c in range(32, 127)})
    vocab["[UNK]"] = 98
    vocab.update({f"<f{i}>": i for i in range(99, CFG.text.vocab_size) if i not in specials.values()})
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex(r"[\s\S]"), behavior="isolated")
    tok.decoder = decoders.Fuse()
    tok.add_special_tokens(list(specials))
    return PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", clean_up_tokenization_spaces=False)


def test_the_hf_tokenizer_matches_the_tiny_one():
    text = "<|im_start|>system\nFind <|vision_start|><|video_pad|><|video_pad|><|vision_end|> 1.5 to 2!<|im_end|>"
    tok, tiny = hf_tokenizer(), TinyTokenizer()
    assert tok.encode(text, add_special_tokens=False) == tiny.encode(text)
    ids = tiny.encode("<answer>1.5 to 2</answer><|im_end|>")
    assert tok.decode(ids, skip_special_tokens=False) == tiny.decode(ids)


def test_checkpoints_carry_their_tokenizer(tmp_path, clips, monkeypatch):
    """No patch on from_pretrained: the base checkpoint holds an HF
    tokenizer, every checkpoint the trainer writes holds it too, and round
    0's evaluate and round 1's train load them."""
    monkeypatch.chdir(tmp_path)
    base = _port_base(tmp_path / "base_model")
    hf_tokenizer().save_pretrained(base)
    loaded = []
    real = Qwen25VLProcessor.from_pretrained.__func__

    def spy(cls, path, **kw):
        processor = real(cls, path, **kw)
        loaded.append((path, type(processor.tokenizer).__name__))
        return processor

    monkeypatch.setattr(Qwen25VLProcessor, "from_pretrained", classmethod(spy))
    data = _annotations(tmp_path / "train.json", clips)
    train_sf.main(train_sf.get_args(_sf_args(base, data, "--rounds", "2", "--filter_task", "random_sample")),
                  device="cpu")
    ckpt0 = train_sf.smallest_checkpoint("exp/round_0")
    for d in (ckpt0, "exp/round_0", train_sf.smallest_checkpoint("exp/round_1")):
        assert {"tokenizer.json", "tokenizer_config.json"} <= set(os.listdir(d)), d
    # round 0: train from the base, evaluate its checkpoint; round 1: train from that checkpoint, evaluate its own
    assert [p for p, _ in loaded] == [base, ckpt0, ckpt0, train_sf.smallest_checkpoint("exp/round_1")]
    assert {name for _, name in loaded} == {"PreTrainedTokenizerFast"}
    recs = [json.loads(line) for line in open("exp/round_0/filtering_epoch0/tg_0_1.jsonl")]
    assert [r["qid"] for r in recs] == ["tvg_0", "tvg_1"] and all(isinstance(r["output_text"], str) for r in recs)


def test_jax_checkpoints_drop_the_tokenizer(tmp_path):
    """ROADMAP §C: the JAX package's save_checkpoint writes no tokenizer, so
    its directory does not load as a processor; the port's does."""
    import jax.numpy as jnp

    from time_r1_tpu.models.processor import Qwen25VLProcessor as JaxProcessor
    from time_r1_tpu.rl.trainer import GRPOTrainer as JaxTrainer
    from time_r1_tpu.rl.trainer import TrainConfig as JaxTrainConfig
    from time_r1_tpu_torch.rl.trainer import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    tok = hf_tokenizer()
    kw = dict(pad_token_id=CFG.pad_token_id, eos_token_id=CFG.eos_token_id)
    rewards = [REWARD_FUNCS_REGISTRY["format"]]
    jtr = JaxTrainer(jax_params(cfg=JCFG), JCFG, JaxProcessor(tok, **kw), rewards,
                     config=JaxTrainConfig(output_dir=str(tmp_path / "j"), report_to="none", beta=0.0),
                     dtype=jnp.float32)
    jtr.save_checkpoint(str(tmp_path / "j" / "checkpoint-1"))
    with pytest.raises((ValueError, OSError)):
        JaxProcessor.from_pretrained(str(tmp_path / "j" / "checkpoint-1"))

    tr = GRPOTrainer(port_params(jax_params()), CFG, Qwen25VLProcessor(tok, **kw), rewards,
                     config=TrainConfig(output_dir=str(tmp_path / "p"), report_to="none", beta=0.0),
                     dtype=torch.float32, device="cpu")
    tr.save_checkpoint(str(tmp_path / "p" / "checkpoint-1"))
    back = Qwen25VLProcessor.from_pretrained(str(tmp_path / "p" / "checkpoint-1"))
    text = "<|im_start|>user\n<|vision_start|><|video_pad|><|vision_end|> when?<|im_end|>"
    assert back.tokenizer.encode(text, add_special_tokens=False) == tok.encode(text, add_special_tokens=False)
    # a stand-in tokenizer has no files to write: the checkpoint holds none
    tiny = GRPOTrainer(port_params(jax_params()), CFG, Qwen25VLProcessor(TinyTokenizer(), **kw), rewards,
                       config=TrainConfig(output_dir=str(tmp_path / "t"), report_to="none", beta=0.0),
                       dtype=torch.float32, device="cpu")
    tiny.save_checkpoint(str(tmp_path / "t"))
    assert not any(f.startswith("tokenizer") for f in os.listdir(tmp_path / "t"))
