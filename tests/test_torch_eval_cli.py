"""The port's evaluation entry points (`time_r1_tpu_torch/cli/{evaluate,eval_all,
calc_difficulty,demo}.py`) against the JAX package's, on the CPU, with the
tiny config's weights in f32 (`params_from_jax`), the tiny tokenizer and
clips written with OpenCV (tests/test_torch_video.py::write_clip):

- the parsers have the JAX package's dests and defaults (the demo's default
  video path aside), and every CLI's `--help` works;
- `evaluate.main` writes the JAX package's jsonl records (greedy
  output_text, pred, target, qid, duration) through `Engine`, and through
  `PagedEngine` and `ContinuousEngine` (JAX's continuous engines set to f32
  as well); a resume after a cut finishes the shard, a second one adds
  nothing; an undecodable video gets its scored-as-zero record; the int8 KV
  cache on the slot engine is refused; MCQ on the train split gives the
  same prob records, and on the test split the two-pass answer forcing the
  same texts;
- quantized serving from a checkpoint the port wrote (int8 weights, int8
  KV);
- over a mesh of 2 gloo ranks (`test_torch_pipeline.cli_worker`),
  `evaluate.main` with --tensor_parallel_size 2 (alone, with
  --use_continuous_batching over the paged pool with int8 weights and int8
  pages and over the slot engine, and with --quantization int4) and with
  --pipeline_parallel_size 2 (alone and with --use_continuous_batching,
  which it ignores, as JAX does), and `demo.main` with
  --pipeline_parallel_size 2, from a checkpoint the port wrote: the records
  one process writes with the same flags, global rank 0 the only writer;
  the refusals that remain (JAX's ValueErrors: prob-based MCQ under PP, too
  few ranks);
- `eval_all.score_dir` and `main` on the same shards give JAX's scores, and
  the EgoSchema upload payload is JAX's (`requests.post` patched in both);
- `calc_difficulty.merge` writes a byte-equal train_v4_cloud.json at the
  same nested path;
- `demo.main` answers as JAX's."""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_video import jax_native_libs, write_clip
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu.cli import calc_difficulty as jax_calc
from time_r1_tpu.cli import demo as jax_demo
from time_r1_tpu.cli import eval_all as jax_eval_all
from time_r1_tpu.cli import evaluate as jax_evaluate
from time_r1_tpu.models.processor import Qwen25VLProcessor as JaxProcessor
from time_r1_tpu.sampler import Engine as JaxEngine
from time_r1_tpu_torch.cli import calc_difficulty, demo, eval_all, evaluate, process_data, train_sf
from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
from time_r1_tpu_torch.sampler import Engine

torch.set_num_threads(2)

PIXELS = ["--total_pixels", str(8 * 28 * 28), "--min_pixels", str(4 * 28 * 28)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two clips, a tvgbench_filter file over them and the two packages'
    f32 engines and processors over the same weights."""
    jax_native_libs()
    root = tmp_path_factory.mktemp("eval_cli")
    a = write_clip(root / "a.mp4", seed=0)
    b = write_clip(root / "b.mp4", frames=16, fps=4.0, seed=1)
    ann = [
        {"video": a, "duration": 3.0, "timestamp": [0.5, 1.5], "sentence": "a door opens", "qid": "tvg_0",
         "video_start": 0.0, "video_end": 2.0, "pred": None},
        {"video": b, "duration": 4.0, "timestamp": [1.0, 3.0], "sentence": "a man sits", "qid": "tvg_1",
         "video_start": 1.0, "video_end": 3.5, "pred": None},
        {"video": a, "duration": 3.0, "timestamp": [2.0, 3.0], "sentence": "lights go out", "qid": "tvg_2",
         "pred": None},
    ]
    (root / "ann.json").write_text(json.dumps(ann))
    jp = jax_params()
    kw = dict(pad_token_id=CFG.pad_token_id, eos_token_id=CFG.eos_token_id)
    return dict(
        root=root, clip=a, ann=str(root / "ann.json"),
        port=(Engine(port_params(jp), CFG, dtype=torch.float32, device="cpu"), Qwen25VLProcessor(TinyTokenizer(), **kw)),
        jax=(JaxEngine(jp, JCFG, dtype=jnp.float32), JaxProcessor(TinyTokenizer(), **kw)),
    )


def _argv(split, out, *extra, datasets=("tvgbench_filter",)):
    return ["--model_base", "unused", "--datasets", *datasets, "--split", split, "--output_dir", str(out),
            "--use_r1_thinking_prompt", "--max_new_tokens", "6", "--num_workers", "0", *PIXELS, *extra]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_both(setup, tmp_path, *extra, split=None, datasets=("tvgbench_filter",)):
    split = split or setup["ann"]
    got = evaluate.main(evaluate.get_args(_argv(split, tmp_path / "port", *extra, datasets=datasets)),
                        *setup["port"], device="cpu")
    want = jax_evaluate.main(jax_evaluate.get_args(_argv(split, tmp_path / "jax", *extra, datasets=datasets)),
                             *setup["jax"])
    assert os.path.basename(got) == os.path.basename(want)
    return _records(got), _records(want), got


def test_parsers_match_jax():
    base = ["--model_base", "m", "--datasets", "tvgbench_filter"]
    assert vars(evaluate.get_args(base)) == vars(jax_evaluate.get_args(base))
    mcq = ["--model_base", "m", "--datasets", "charades", "mvbench"]
    assert vars(evaluate.get_args(mcq)) == vars(jax_evaluate.get_args(mcq))
    assert evaluate.get_args(mcq).datatype == "mcq"
    sf = ["--model_name_or_path", "m", "--exp_dir", "e", "--initial_data", "d.json"]
    from time_r1_tpu.cli import train_sf as jax_train_sf

    assert vars(train_sf.get_args(sf)) == vars(jax_train_sf.get_args(sf))
    got, want = vars(demo.get_args([])), vars(jax_demo.get_args([]))
    assert got.pop("video_path") == "./assets/OHOFG.mp4"
    want.pop("video_path")
    assert got == want


@pytest.mark.parametrize("mod", [evaluate, eval_all, calc_difficulty, process_data, train_sf, demo])
def test_help_runs(mod, capsys):
    with pytest.raises(SystemExit) as e:
        (mod.get_args if hasattr(mod, "get_args") else mod.main)(["--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_evaluate_equal_to_jax_with_resume(setup, tmp_path):
    got, want, path = _run_both(setup, tmp_path)
    assert got == want
    assert [r["qid"] for r in got] == ["tvg_0", "tvg_1", "tvg_2"]
    assert all(isinstance(r["pred"], list) and len(r["pred"]) == 2 for r in got)
    summary = open(os.path.join(os.path.dirname(path), "timing_summary_vllm.txt")).read()
    assert "Total program execution time" in summary and "Items evaluated: 3" in summary
    # a run cut after its first record resumes by qid; a finished one adds nothing
    with open(path) as f:
        first = f.readline()
    with open(path, "w") as f:
        f.write(first)
    args = evaluate.get_args(_argv(setup["ann"], tmp_path / "port"))
    for _ in range(2):
        evaluate.main(args, *setup["port"], device="cpu")
        assert _records(path) == want


def test_undecodable_video_gets_a_record(setup, tmp_path):
    from time_r1_tpu_torch.utils.metrics import score_tg_records

    bad = tmp_path / "not_a_video.mp4"
    bad.write_bytes(b"garbage bytes, no container")
    ann = json.loads(open(setup["ann"]).read())[:1]
    ann.insert(0, {"video": str(bad), "duration": 10.0, "timestamp": [1.0, 2.0], "sentence": "broken row",
                   "qid": "tvg_bad", "pred": None})
    split = tmp_path / "ann_bad.json"
    split.write_text(json.dumps(ann))
    got, want, path = _run_both(setup, tmp_path, split=str(split))
    assert [r["qid"] for r in got] == ["tvg_bad", "tvg_0"]
    assert {k: v for k, v in got[0].items() if k != "error"} == {k: v for k, v in want[0].items() if k != "error"}
    assert got[0]["pred"] == [None, None] and got[0]["output_text"] == "" and got[0]["error"]
    assert got[1] == want[1]
    scores = score_tg_records(got)
    assert scores["tvg_bad"] == 0.0 and len(scores) == 2
    evaluate.main(evaluate.get_args(_argv(str(split), tmp_path / "port")), *setup["port"], device="cpu")
    assert len(_records(path)) == 2  # the failed row is not tried again


def _f32(cls):
    return functools.partial(cls, dtype=jnp.float32)


@pytest.mark.parametrize("flags", [["--kv_block_size", "128"], ["--kv_block_size", "0"]], ids=["paged", "continuous"])
def test_continuous_engines_equal_to_jax(setup, tmp_path, monkeypatch, flags):
    """Both packages through their continuous engines, in f32 (the JAX
    package's evaluate builds them in bf16 whatever the bucket engine's
    dtype; the port's take the bucket engine's), two slots for three items;
    and the same records as the bucket Engine's."""
    import time_r1_tpu.sampler.continuous as jcont
    import time_r1_tpu.sampler.paged as jpaged

    monkeypatch.setattr(jpaged, "PagedEngine", _f32(jpaged.PagedEngine))
    monkeypatch.setattr(jcont, "ContinuousEngine", _f32(jcont.ContinuousEngine))
    made = []
    for name in ("PagedEngine", "ContinuousEngine"):
        cls = getattr(evaluate, name)
        monkeypatch.setattr(evaluate, name, lambda *a, _cls=cls, **kw: made.append(_cls(*a, **kw)) or made[-1])
    extra = ["--use_continuous_batching", "--max_model_len", "1000", "--batch_size", "2", *flags]
    got, want, _ = _run_both(setup, tmp_path, *extra)
    assert got == want
    want_cls = "PagedEngine" if flags[1] != "0" else "ContinuousEngine"
    assert [type(e).__name__ for e in made] == [want_cls]
    assert made[0].dtype == torch.float32 and made[0].max_slots == 2
    if want_cls == "PagedEngine":
        assert made[0].max_len == 1024  # rounded up to the page size
    bucket = evaluate.main(evaluate.get_args(_argv(setup["ann"], tmp_path / "bucket")), *setup["port"], device="cpu")
    assert _records(bucket) == got


def test_int8_kv_on_the_slot_engine_is_refused(setup, tmp_path):
    extra = ["--use_continuous_batching", "--kv_block_size", "0", "--kv_cache_dtype", "int8"]
    with pytest.raises(ValueError, match="requires the paged pool"):
        evaluate.main(evaluate.get_args(_argv(setup["ann"], tmp_path / "p", *extra)), *setup["port"], device="cpu")
    with pytest.raises(ValueError, match="requires the paged pool"):
        jax_evaluate.main(jax_evaluate.get_args(_argv(setup["ann"], tmp_path / "j", *extra)), *setup["jax"])


@pytest.fixture()
def mvbench(setup, monkeypatch):
    """An mvbench tree of MCQ rows over the first clip, under both packages' DATA_ROOT."""
    import time_r1_tpu.data.loaders as JL
    import time_r1_tpu_torch.data.loaders as L

    root = setup["root"] / "data"
    vdir = root / "mvbench" / "video" / "perception" / "videos"
    if not vdir.exists():
        vdir.mkdir(parents=True)
        shutil.copy(setup["clip"], vdir / "a.mp4")
        (root / "mvbench" / "json").mkdir()
        (root / "mvbench" / "json" / "action_count.json").write_text(json.dumps([
            {"video": "a.mp4", "question": "how many?", "candidates": ["1", "2", "3"], "answer": "2"},
            {"video": "a.mp4", "question": "what next?", "candidates": ["run", "sit"], "answer": "sit", "end": 2.0},
        ]))
    monkeypatch.setattr(L, "DATA_ROOT", str(root))
    monkeypatch.setattr(JL, "DATA_ROOT", str(root))


def test_mcq_prob_records_equal_to_jax(setup, tmp_path, mvbench):
    got, want, _ = _run_both(setup, tmp_path, split="train", datasets=("mvbench",))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"qid", "pred", "target", "duration", "probs"}
        assert {k: g[k] for k in ("qid", "pred", "target", "duration")} == \
            {k: w[k] for k in ("qid", "pred", "target", "duration")}
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=1e-4, atol=1e-4)
        assert abs(sum(g["probs"]) - 1.0) < 1e-6


def test_mcq_answer_forcing_equal_to_jax(setup, tmp_path, mvbench):
    got, want, _ = _run_both(setup, tmp_path, split="test", datasets=("mvbench",))
    assert got == want and len(got) == 2
    assert all(r["pred"] is None and r["output_text"] for r in got)


def test_quantized_serving_from_a_port_checkpoint(setup, tmp_path, monkeypatch):
    """The disk path: a checkpoint the port wrote, load_checkpoint, then an
    Engine with int8 weights and an int8 KV cache, as the flags ask."""
    from time_r1_tpu_torch.models.qwen25vl.convert import NATIVE_CONFIG, config_to_plain_dict
    from time_r1_tpu_torch.utils.checkpoint import save_params

    ckpt = tmp_path / "ckpt"
    save_params(str(ckpt), port_params(jax_params()))
    (ckpt / NATIVE_CONFIG).write_text(json.dumps(config_to_plain_dict(CFG)))
    processor = setup["port"][1]
    monkeypatch.setattr(Qwen25VLProcessor, "from_pretrained", classmethod(lambda cls, path, **kw: processor))
    built = []

    class Spy(Engine):
        def __init__(self, *a, **kw):
            built.append(kw)
            super().__init__(*a, **kw)

    monkeypatch.setattr(evaluate, "Engine", Spy)
    argv = _argv(setup["ann"], tmp_path / "q8", "--quantization", "int8", "--kv_cache_dtype", "int8")
    argv[1] = str(ckpt)
    recs = _records(evaluate.main(evaluate.get_args(argv), device="cpu"))
    assert [r["qid"] for r in recs] == ["tvg_0", "tvg_1", "tvg_2"]
    assert all(isinstance(r["pred"], list) and isinstance(r["output_text"], str) for r in recs)
    assert built == [dict(device="cpu", quantization="int8", kv_cache_quant=True)]


def _port_checkpoint(path):
    from time_r1_tpu_torch.models.qwen25vl.convert import NATIVE_CONFIG, config_to_plain_dict
    from time_r1_tpu_torch.utils.checkpoint import save_params

    save_params(str(path), port_params(jax_params()))
    (path / NATIVE_CONFIG).write_text(json.dumps(config_to_plain_dict(CFG)))
    return str(path)


TP2, PP2 = ["--tensor_parallel_size", "2"], ["--pipeline_parallel_size", "2"]
CONTINUOUS = ["--use_continuous_batching", "--max_model_len", "1000", "--batch_size", "2"]
# tag: (the mesh's flags, the other flags, which one process runs with too)
MESH_FLAGS = {
    "tp2": (TP2, []),
    "pp2": (PP2, []),
    "tp2_paged_int8": (TP2, [*CONTINUOUS, "--kv_block_size", "128", "--quantization", "int8",
                             "--kv_cache_dtype", "int8"]),
    "tp2_continuous": (TP2, [*CONTINUOUS, "--kv_block_size", "0"]),
    "tp2_int4": (TP2, ["--quantization", "int4"]),
    "pp2_continuous": (PP2, CONTINUOUS),
}


def _one_process(setup, out, flags):
    """`evaluate.main` in one process with `flags` (no mesh), over an f32
    engine quantized as the flags ask."""
    args = evaluate.get_args(_argv(setup["ann"], out, *flags))
    engine, processor = setup["port"]
    if args.quantization or args.kv_cache_dtype:
        engine = Engine(port_params(jax_params()), CFG, dtype=torch.float32, device="cpu",
                        quantization=args.quantization or None, kv_cache_quant=args.kv_cache_dtype == "int8")
    return _records(evaluate.main(args, engine, processor, device="cpu"))


@pytest.fixture(scope="module")
def mesh_runs(setup, tmp_path_factory):
    """`cli.evaluate` with each of MESH_FLAGS and `cli.demo
    --pipeline_parallel_size 2` over 2 gloo ranks
    (`test_torch_pipeline.cli_worker`) from a port checkpoint, and the same
    two CLIs in one process over the same weights (f32), `cli.evaluate`
    with each tag's other flags."""
    from test_torch_ring_attention import spawn_ranks

    root = tmp_path_factory.mktemp("mesh_cli")
    ckpt = _port_checkpoint(root / "ckpt")
    demo_argv = ["--model_base", ckpt, "--video_path", setup["clip"], "--max_new_tokens", "6", *PIXELS]
    one = {"evaluate": {tag: _one_process(setup, root / "one" if not other else root / f"one_{tag}", other)
                        for tag, (_, other) in MESH_FLAGS.items()},
           "demo": demo.main(demo.get_args([*demo_argv, "--output_dir", str(root / "demo_one")]), *setup["port"],
                             device="cpu")}
    job = dict(pad=CFG.pad_token_id, eos=CFG.eos_token_id,
               evaluate={tag: [*_argv(setup["ann"], root / tag, *mesh, *other)[:1], ckpt,
                               *_argv(setup["ann"], root / tag, *mesh, *other)[2:]]
                         for tag, (mesh, other) in MESH_FLAGS.items()},
               demo=[*demo_argv, "--output_dir", str(root / "demo_pp2"), "--pipeline_parallel_size", "2"])
    (root / "cli.json").write_text(json.dumps(job))
    ranks = spawn_ranks("test_torch_pipeline", "cli_worker", 2, root)
    return dict(root=root, ckpt=ckpt, one=one, ranks=ranks)


@pytest.mark.parametrize("tag", list(MESH_FLAGS))
def test_evaluate_over_a_mesh_equals_one_process(mesh_runs, tag):
    """Global rank 0 writes the records, which equal one process's with the
    same flags but the mesh's (the JAX package's CLI holds its PP run to its
    single-device one the same way, tests/test_pp_generate.py:59); the other
    rank writes nothing. Under PP --use_continuous_batching changes
    nothing."""
    ranks = mesh_runs["ranks"]
    assert ranks[0][tag] == ranks[1][tag]  # the same path: rank 0's file
    recs = _records(ranks[0][tag])
    assert [r["qid"] for r in recs] == ["tvg_0", "tvg_1", "tvg_2"]
    assert recs == mesh_runs["one"]["evaluate"][tag]
    assert sorted(os.listdir(mesh_runs["root"] / tag)) == sorted(os.listdir(mesh_runs["root"] / "one"))
    if tag == "pp2_continuous":
        assert recs == _records(ranks[0]["pp2"])


def test_demo_over_a_pipeline_equals_one_process(mesh_runs):
    ranks = mesh_runs["ranks"]
    assert ranks[0]["demo"] == ranks[1]["demo"] == mesh_runs["one"]["demo"]
    assert _records(mesh_runs["root"] / "demo_pp2" / "tmp_output.jsonl") == \
        _records(mesh_runs["root"] / "demo_one" / "tmp_output.jsonl")


# the refusals that remain over a mesh, JAX's ValueErrors: (flags, error, message)
MESH_REFUSALS = {
    "pp_prob_mcq": (["--pipeline_parallel_size", "2"], ValueError, "prob-based MCQ scoring needs the bucket engine"),
    "tp_too_few_ranks": (["--tensor_parallel_size", "2"], ValueError, "needs 2 ranks"),
    "pp_too_few_ranks": (["--pipeline_parallel_size", "2"], ValueError,
                         r"pipeline_parallel_size=2 × tensor_parallel_size=1 needs 2 devices but only 1 exist"),
}


@pytest.mark.parametrize("case", list(MESH_REFUSALS))
def test_mesh_refusals(setup, tmp_path, case):
    flags, error, message = MESH_REFUSALS[case]
    argv = _argv("train" if case == "pp_prob_mcq" else setup["ann"], tmp_path / "out", *flags,
                 datasets=("mvbench",) if case == "pp_prob_mcq" else ("tvgbench_filter",))
    argv[1] = _port_checkpoint(tmp_path / "ckpt")
    with pytest.raises(error, match=message):
        evaluate.main(evaluate.get_args(argv), device="cpu")


def test_demo_pipeline_needs_its_ranks(setup, tmp_path):
    argv = ["--model_base", _port_checkpoint(tmp_path / "ckpt"), "--video_path", setup["clip"],
            "--output_dir", str(tmp_path / "out"), "--pipeline_parallel_size", "2", *PIXELS]
    with pytest.raises(ValueError, match="needs 2 devices but only 1 exist"):
        demo.main(demo.get_args(argv), device="cpu")


def test_evaluate_runs_on_the_card_unless_asked(setup, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    from time_r1_tpu_torch.models.qwen25vl.convert import NATIVE_CONFIG, config_to_plain_dict
    from time_r1_tpu_torch.utils.checkpoint import save_params

    ckpt = tmp_path / "ckpt"
    save_params(str(ckpt), port_params(jax_params()))
    (ckpt / NATIVE_CONFIG).write_text(json.dumps(config_to_plain_dict(CFG)))
    argv = _argv(setup["ann"], tmp_path / "out")
    argv[1] = str(ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(evaluate.get_args(argv))


def _tg_records(rng, n, prefix):
    recs = []
    for i in range(n):
        s = round(float(rng.uniform(0, 20)), 2)
        gt = [s, round(s + float(rng.uniform(1, 8)), 2)]
        pred = [round(s + float(rng.uniform(-3, 3)), 2), round(s + float(rng.uniform(0, 9)), 2)]
        recs.append({"qid": f"{prefix}{i}", "pred": pred, "target": gt, "duration": 30.0,
                     "output_text": f"<answer>{pred[0]} to {pred[1]}</answer>"})
    recs += [{"qid": f"{prefix}none", "pred": [None, None], "target": [1.0, 2.0], "duration": 9.0,
              "output_text": "starts near 1.5 and ends at 2.25"},
             {"qid": f"{prefix}empty", "pred": None, "target": [3.0, 4.0], "duration": 9.0, "output_text": ""}]
    return recs


def _write_shards(d, recs, n_shards=2):
    d.mkdir(parents=True, exist_ok=True)
    for s in range(n_shards):
        with open(d / f"tg_{s}_{n_shards}.jsonl", "w") as f:
            for r in recs[s::n_shards]:
                f.write(json.dumps(r) + "\n")


def test_eval_all_equal_to_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    tg = _tg_records(rng, 9, "c")
    mcq = [{"qid": f"m{i}", "pred": int(p) if i % 3 else None, "target": int(t), "duration": None,
            "output_text": f"The answer is ({chr(65 + int(p))})." if i % 4 else chr(65 + int(p))}
           for i, (p, t) in enumerate(zip(rng.integers(0, 4, 10), rng.integers(0, 4, 10)))]
    for name in ("port", "jax"):
        root = tmp_path / name / "model"
        _write_shards(root / "charades_test", tg)
        _write_shards(root / "charades_captioning", tg)
        _write_shards(root / "mvbench_test", mcq)
        (root / "tvgbench_empty").mkdir()
    for ds in ("charades", "mvbench"):
        d = str(tmp_path / "port" / "model" / f"{ds}_test")
        assert eval_all.score_dir(d, ds) == jax_eval_all.score_dir(d, ds)
        assert eval_all.load_records(d) == jax_eval_all.load_records(d)
    assert eval_all.score_dir(str(tmp_path / "port" / "model" / "tvgbench_empty"), "tvgbench") is None
    assert eval_all.find_dataset_results("charades", "model", str(tmp_path / "port")) == \
        jax_eval_all.find_dataset_results("charades", "model", str(tmp_path / "port"))
    for mod, name in ((eval_all, "port"), (jax_eval_all, "jax")):
        mod.main(["--model_name", "model", "--eval_root", str(tmp_path / name),
                  "--dataset", "charades", "mvbench", "tvgbench"])
    out = capsys.readouterr().out
    assert "IoU R1@ mIoU" in out
    for d in ("charades_test", "mvbench_test"):
        assert (tmp_path / "port" / "model" / d / "scores.json").read_bytes() == \
            (tmp_path / "jax" / "model" / d / "scores.json").read_bytes()
    assert not (tmp_path / "port" / "model" / "charades_captioning" / "scores.json").exists()


def test_egoschema_upload_payload_equal_to_jax(tmp_path, monkeypatch):
    import random

    import requests

    original = [{"qid": f"egoschema_{i}", "video": f"/videos/vid{i}.mp4"} for i in range(6)]
    d = tmp_path / "egoschema_test"
    d.mkdir()
    with open(d / "mcq_0_1.jsonl", "w") as f:
        for i in range(6):
            text = ["I pick (B).", "(A) or (D)", "no letter", "", "(E)", "maybe c"][i]
            f.write(json.dumps({"qid": f"egoschema_{i}", "pred": None, "target": 0, "output_text": text}) + "\n")
    sent = []

    class Response:
        text = "ok"

        def raise_for_status(self):
            pass

        def json(self):
            return {"accuracy": 0.5}

    monkeypatch.setattr(requests, "post", lambda url, headers=None, json=None: sent.append((url, json)) or Response())
    results = []
    for mod in (eval_all, jax_eval_all):
        random.seed(42)
        results.append(mod.eval_egoschema_online(str(d), original, "http://localhost:1/upload"))
    assert results[0] == results[1] == {"accuracy": 0.5}
    assert sent[0] == sent[1] and len(sent[0][1]) == 6
    assert sent[0][1]["vid0"] == 1 and sent[0][1]["vid1"] == 3 and sent[0][1]["vid4"] == 4

    def refuse(url, headers=None, json=None):
        raise requests.ConnectionError("refused")

    monkeypatch.setattr(requests, "post", refuse)
    random.seed(42)
    assert eval_all.eval_egoschema_online(str(d), original, "http://localhost:1/upload") == \
        {"status": "error", "message": "refused"}


def test_calc_difficulty_merge_byte_equal(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(1)
    recs = _tg_records(rng, 7, "tvg_")
    ann = [{"video": f"v{i}.mp4", "duration": 30.0, "timestamp": r["target"], "sentence": f"event {i}",
            "qid": r["qid"], "video_start": None, "pred": None} for i, r in enumerate(recs)]
    ann.append({"video": "x.mp4", "duration": 5.0, "timestamp": [0, 1], "sentence": "never evaluated", "qid": "gone"})
    monkeypatch.chdir(tmp_path)
    (tmp_path / "train.json").write_text(json.dumps(ann))
    _write_shards(tmp_path / "exp" / "filtering_epoch0", recs)
    paths = []
    for mod, name in ((calc_difficulty, "port"), (jax_calc, "jax")):
        paths.append(mod.merge(input_dir="exp/filtering_epoch0", split="train.json", output_dir=f"out_{name}"))
    assert paths[0] == os.path.join("out_port", "exp/filtering_epoch0", "train_v4_cloud.json")
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert calc_difficulty.load_new_data("exp/filtering_epoch0") == jax_calc.load_new_data("exp/filtering_epoch0")
    merged = json.loads(open(paths[0]).read())
    assert len(merged) == 9 and all("difficulty" in d and "pred" in d for d in merged)
    assert next(d for d in merged if d["qid"] == "tvg_none")["pred"] == [1.5, 2.25]  # the rescue parser
    assert "Not All!! Attention!!" in capsys.readouterr().out
    calc_difficulty.main(["--input", "exp/filtering_epoch0", "--split", "train.json", "--output_dir", "cli"])
    assert open(os.path.join("cli", "exp/filtering_epoch0", "train_v4_cloud.json"), "rb").read() == \
        open(paths[1], "rb").read()


def test_demo_equal_to_jax(setup, tmp_path):
    argv = ["--video_path", setup["clip"], "--max_new_tokens", "6", *PIXELS]
    got = demo.main(demo.get_args([*argv, "--output_dir", str(tmp_path / "port")]), *setup["port"], device="cpu")
    want = jax_demo.main(jax_demo.get_args([*argv, "--output_dir", str(tmp_path / "jax")]), *setup["jax"])
    assert got == want
    assert demo.PROMPT_TEMPLATE == jax_demo.PROMPT_TEMPLATE
    assert _records(tmp_path / "port" / "tmp_output.jsonl") == _records(tmp_path / "jax" / "tmp_output.jsonl")
    req, jreq = demo.build_request(setup["port"][1], demo.get_args(argv)), \
        jax_demo.build_request(setup["jax"][1], jax_demo.get_args(argv))
    assert req.input_ids == jreq.input_ids and req.grid_thw == jreq.grid_thw
    np.testing.assert_array_equal(np.asarray(req.patches), np.asarray(jreq.patches))
