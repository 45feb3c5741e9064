"""The port's parity harness (`time_r1_tpu_torch/cli/parity.py`) and what it
needs, against the JAX package, on the CPU:

- `decoder_forward(collect_hiddens=True)`: each layer's output against JAX's
  (f32, within 1e-5) and against HF transformers' `hidden_states` (the
  harness's atol/rtol); the paths that refuse it;
- `main(..., device="cpu")` end to end on an HF-format directory that
  transformers wrote from the tiny config (tests/test_parity_harness.py's
  fixture) and a clip written with OpenCV as `--video_path`: round 1 records
  the demo, passes the activations and the SYNTHETIC benchmark; round 2 with
  `--expected` passes the demo; a tampered fixture fails with rc 1;
- against JAX's `parity.main` on the same directory and clip: the same status
  for each check, both packages' per-layer reports within tolerance, the same
  benchmark qids; the same demo answer where both decode in f32;
- the intended differences: (a) the synthetic shard is scored under
  tvgbench_filter's metric name ("tvgbench"), JAX's under `--datasets[0]`;
  (b) a synthetic eval that raises is "fail" in the port and "skip" in JAX;
  (c) a failed import of transformers is "skip" in both, any other exception
  of the oracle surfaces in the port; the stemmer's ImportError surfaces;
- `rouge_l_fmeasure` and `diversity_reward_func` equal to JAX's, exactly;
- `PhaseTimers.write` / `reset`, and `trace`."""

import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_model_parity import CFG, hf_model  # noqa: F401  (fixture)
from test_parity_harness import hf_ckpt_dir as jax_hf_ckpt_dir  # noqa: F401  (fixture)
from test_torch_video import jax_native_libs, write_clip
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu.cli import parity as jax_parity
from time_r1_tpu.models.processor import Qwen25VLProcessor as JaxProcessor
from time_r1_tpu.utils import metrics as jax_metrics
from time_r1_tpu.utils import profiling as jax_profiling
from time_r1_tpu.utils import rewards as jax_rewards
from time_r1_tpu_torch.cli import parity
from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
from time_r1_tpu_torch.utils import metrics, profiling, rewards

torch.set_num_threads(2)

PIXELS = ["--total_pixels", str(8 * 28 * 28), "--min_pixels", str(4 * 28 * 28)]
LAYER_RE = re.compile(r"layer (\d+).*max\|Δ\| = (\S+)\s+\(\|h\|max (\S+)\)")


def _processors(monkeypatch):
    """Both packages' `Qwen25VLProcessor.from_pretrained` give the tiny
    tokenizer's processor (no tokenizer files in the repository)."""
    kw = dict(pad_token_id=CFG.pad_token_id, eos_token_id=CFG.eos_token_id)
    for cls in (Qwen25VLProcessor, JaxProcessor):
        proc = cls(TinyTokenizer(), **kw)
        monkeypatch.setattr(cls, "from_pretrained", classmethod(lambda c, p, proc=proc: proc))


def _spy_calc_score(monkeypatch, module, seen: list):
    real = module.calc_score

    def spy(scores, name):
        seen.append(name)
        return real(scores, name)

    monkeypatch.setattr(module, "calc_score", spy)


def _argv(ckpt, out, clip, *extra):
    return ["--model_base", ckpt, "--output_dir", str(out), "--video_path", clip, *PIXELS,
            "--max_new_tokens", "4", "--charades_n", "2", *extra]


def _report(out):
    with open(os.path.join(out, "parity_report.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def hf_ckpt_dir(jax_hf_ckpt_dir):  # noqa: F811
    """tests/test_parity_harness.py's directory, with a pad id of the tiny
    vocabulary at the top level: without one both packages read the published
    default 151643 (so do they for the tiny config's 0, which `from_hf_dict`
    takes for unset), outside the vocabulary; JAX's embedding lookup clamps
    it and the port's refuses. The engines' pad positions are masked, so any
    id in the vocabulary serves."""
    path = os.path.join(jax_hf_ckpt_dir, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["pad_token_id"] = CFG.text.vocab_size - 1
    with open(path, "w") as f:
        json.dump(cfg, f)
    return jax_hf_ckpt_dir


@pytest.fixture(scope="module")
def runs(hf_ckpt_dir, tmp_path_factory):
    """Round 1 of both packages' harness, the port's round 2 with the
    recorded fixture, and the port's run against a tampered fixture."""
    jax_native_libs()
    root = tmp_path_factory.mktemp("parity")
    clip = write_clip(root / "clip.mp4")
    out = {"root": root, "clip": clip, "ckpt": hf_ckpt_dir, "scored_as": {"port": [], "jax": []}}
    with pytest.MonkeyPatch.context() as mp:
        _processors(mp)
        _spy_calc_score(mp, metrics, out["scored_as"]["port"])
        _spy_calc_score(mp, jax_metrics, out["scored_as"]["jax"])
        out["rc1"] = parity.main(parity.get_args(_argv(hf_ckpt_dir, root / "port1", clip)), device="cpu")
        out["jax_rc1"] = jax_parity.main(jax_parity.get_args(_argv(hf_ckpt_dir, root / "jax1", clip)))
        cand = str(root / "port1" / "demo_candidate.json")
        demo_only = ("--skip_activations", "--skip_benchmark")
        out["rc2"] = parity.main(parity.get_args(_argv(hf_ckpt_dir, root / "port2", clip, "--expected", cand,
                                                       *demo_only)), device="cpu")
        with open(cand) as f:
            tampered = json.load(f)
        tampered["pred"] = [123.0, 456.0]
        with open(root / "tampered.json", "w") as f:
            json.dump(tampered, f)
        out["rc3"] = parity.main(parity.get_args(_argv(hf_ckpt_dir, root / "port3", clip, "--expected",
                                                       str(root / "tampered.json"), *demo_only)), device="cpu")
    return out


def test_round_one_records_the_demo_and_passes(runs):
    report = _report(runs["root"] / "port1")
    assert report["activations"]["status"] == "pass", report["activations"]["detail"]
    assert "layer 00" in report["activations"]["detail"]
    assert "bf16 greedy argmax agreement" in report["activations"]["detail"]
    assert report["demo"]["status"] == "recorded"
    assert os.path.exists(runs["root"] / "port1" / "demo_candidate.json")
    assert report["benchmark"]["status"] == "pass", report["benchmark"]["detail"]
    assert "SYNTHETIC" in report["benchmark"]["detail"]
    assert os.path.exists(runs["root"] / "port1" / "bench" / "scores.json")
    assert os.path.exists(runs["root"] / "port1" / "activations_report.txt")
    assert runs["rc1"] == 0


def test_round_two_verifies_the_fixture_and_a_tampered_one_fails(runs):
    assert _report(runs["root"] / "port2")["demo"]["status"] == "pass"
    assert runs["rc2"] == 0
    report = _report(runs["root"] / "port3")
    assert report["demo"]["status"] == "fail" and "[123.0, 456.0]" in report["demo"]["detail"]
    assert runs["rc3"] == 1


def _layers(detail: str) -> list:
    return [(int(m.group(1)), float(m.group(2)), float(m.group(3))) for m in LAYER_RE.finditer(detail)]


def test_against_jax_parity_main(runs):
    mine, ref = _report(runs["root"] / "port1"), _report(runs["root"] / "jax1")
    assert {k: v["status"] for k, v in mine.items()} == {k: v["status"] for k, v in ref.items()}
    assert runs["rc1"] == runs["jax_rc1"] == 0
    args = parity.get_args(["--model_base", "m"])
    for report in (mine, ref):
        layers = _layers(report["activations"]["detail"])
        assert [l for l, _, _ in layers] == list(range(CFG.text.num_hidden_layers))
        for _, d, scale in layers:
            assert d <= args.atol + args.rtol * scale
    # the same synthetic shard, scored each under its own name: difference (a)
    qids = []
    for side in ("port1", "jax1"):
        shard = [f for f in os.listdir(runs["root"] / side / "bench") if f.endswith(".jsonl")]
        with open(runs["root"] / side / "bench" / shard[0]) as f:
            qids.append([json.loads(line)["qid"] for line in f])
    assert qids[0] == qids[1] == ["parity_0", "parity_1"]
    assert runs["scored_as"] == {"port": ["tvgbench"], "jax": ["charades"]}
    scores = json.loads(mine["benchmark"]["detail"].splitlines()[0].split(" (SYNTHETIC")[0])
    assert set(scores) == {"mIoU", "0.3", "0.5", "0.7", "avg"}


def test_demo_answers_as_jax_in_f32(runs, tmp_path, monkeypatch):
    from time_r1_tpu.models.qwen25vl.convert import load_checkpoint as jax_load
    from time_r1_tpu.sampler import Engine as JaxEngine
    from time_r1_tpu_torch.models.qwen25vl.convert import load_checkpoint
    from time_r1_tpu_torch.sampler import Engine

    kw = dict(pad_token_id=CFG.pad_token_id, eos_token_id=CFG.eos_token_id)
    params, cfg = load_checkpoint(runs["ckpt"], dtype=torch.float32, device="cpu")
    jparams, jcfg = jax_load(runs["ckpt"], dtype=jnp.float32)
    recs = []
    for side, mod, engine, proc in (
        ("port", parity, Engine(params, cfg, dtype=torch.float32, device="cpu"),
         Qwen25VLProcessor(TinyTokenizer(), **kw)),
        ("jax", jax_parity, JaxEngine(jparams, jcfg, dtype=jnp.float32), JaxProcessor(TinyTokenizer(), **kw)),
    ):
        args = mod.get_args(_argv(runs["ckpt"], tmp_path / side, runs["clip"]))
        extra = {"device": "cpu"} if side == "port" else {}
        assert mod.check_demo(args, engine=engine, processor=proc, **extra)[0] == "recorded"
        with open(tmp_path / side / "demo_candidate.json") as f:
            recs.append(json.load(f))
    assert recs[0] == recs[1]


def test_parser_matches_jax():
    base = ["--model_base", "m"]
    got, want = vars(parity.get_args(base)), vars(jax_parity.get_args(base))
    assert got.pop("video_path") == "./assets/OHOFG.mp4"
    want.pop("video_path")
    assert got == want
    assert (got["atol"], got["rtol"]) == (2e-4, 2e-3)


def test_main_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = parity.get_args(["--model_base", str(tmp_path), "--output_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.main(args)


def test_module_runs_as_a_command():
    import subprocess

    out = subprocess.run([sys.executable, "-m", "time_r1_tpu_torch.cli.parity", "--help"], capture_output=True,
                         text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0 and "--skip_activations" in out.stdout


# ---------------------------------------------------------------------------
# difference (b): a synthetic eval that raises
def test_synthetic_eval_failure_is_fail_in_the_port_skip_in_jax(runs, tmp_path, monkeypatch):
    from time_r1_tpu.cli import evaluate as jax_evaluate
    from time_r1_tpu_torch.cli import evaluate

    def failing(args, *a, **kw):
        if args.datasets == ["charades"]:
            raise FileNotFoundError("charades annotations")
        raise RuntimeError("decoder exploded")

    monkeypatch.setattr(evaluate, "main", failing)
    monkeypatch.setattr(jax_evaluate, "main", failing)
    argv = _argv(runs["ckpt"], tmp_path, runs["clip"])
    status, detail = parity.check_benchmark(parity.get_args(argv), device="cpu")
    assert (status, detail) == ("fail", "synthetic benchmark failed: RuntimeError: decoder exploded")
    assert jax_parity.check_benchmark(jax_parity.get_args(argv))[0] == "skip"


# difference (c): the oracle's import
def test_failed_transformers_import_skips_in_both(runs, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # `import transformers` raises ImportError
    argv = _argv(runs["ckpt"], tmp_path, runs["clip"])
    status, detail = parity.check_activations(parity.get_args(argv), device="cpu")
    assert status == "skip" and "transformers unavailable" in detail
    assert jax_parity.check_activations(jax_parity.get_args(argv))[0] == "skip"


class _BrokenTransformers(types.ModuleType):
    def __getattr__(self, name):
        raise RuntimeError(f"broken install: {name}")


def test_other_oracle_exceptions_surface_in_the_port(runs, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", _BrokenTransformers("transformers"))
    argv = _argv(runs["ckpt"], tmp_path, runs["clip"])
    with pytest.raises(RuntimeError, match="broken install"):
        parity.check_activations(parity.get_args(argv), device="cpu")
    assert jax_parity.check_activations(jax_parity.get_args(argv))[0] == "skip"


def test_activations_skip_without_an_hf_config(tmp_path):
    args = parity.get_args(["--model_base", str(tmp_path), "--output_dir", str(tmp_path / "out")])
    status, detail = parity.check_activations(args, device="cpu")
    assert status == "skip" and "no config.json" in detail


# ---------------------------------------------------------------------------
# decoder_forward(collect_hiddens=True)
def _decoder_inputs(seed=0, B=2, S=24):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, S, CFG.text.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    mask = np.ones((B, S), np.int32)
    mask[-1, :5] = 0
    return hidden, pos, mask


def test_collect_hiddens_matches_jax():
    from test_torch_bridge import JCFG, jax_params, port_params
    from time_r1_tpu.models.qwen25vl.language import decoder_forward as jax_decoder
    from time_r1_tpu_torch.models.qwen25vl import decoder_forward

    jp = jax_params()
    hidden, pos, mask = _decoder_inputs()
    want_h, _, want_layers = jax_decoder(jp["text"], JCFG.text, jnp.asarray(hidden), jnp.asarray(pos),
                                         jnp.asarray(mask), collect_hiddens=True)
    p = port_params(jp)
    with torch.no_grad():
        got_h, cache, got_layers = decoder_forward(p["text"], CFG.text, torch.from_numpy(hidden),
                                                   torch.from_numpy(pos), torch.from_numpy(mask),
                                                   collect_hiddens=True)
        plain_h, _ = decoder_forward(p["text"], CFG.text, torch.from_numpy(hidden), torch.from_numpy(pos),
                                     torch.from_numpy(mask))
    assert cache is None
    assert got_layers.shape == (CFG.text.num_hidden_layers, *hidden.shape)
    np.testing.assert_allclose(got_layers.numpy(), np.asarray(want_layers), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=0)
    torch.testing.assert_close(got_h, plain_h, atol=0, rtol=0)  # the default path is unchanged


def test_collect_hiddens_matches_hf(hf_ckpt_dir, hf_model):  # noqa: F811
    from time_r1_tpu_torch.models.qwen25vl import (
        VisionInputs,
        decoder_forward,
        get_rope_index,
        merge_vision_embeddings,
        prepare_vision_inputs,
        vision_forward,
    )
    from time_r1_tpu_torch.models.qwen25vl.convert import load_checkpoint
    from time_r1_tpu_torch.ops.quant import embed_lookup

    params, cfg = load_checkpoint(hf_ckpt_dir, dtype=torch.float32, device="cpu")
    grid = (2, 4, 4)
    patches = np.random.default_rng(1).normal(size=(32, cfg.vision.patch_input_dim)).astype(np.float32)
    ids = parity._fixed_prompt(cfg, grid)
    grid_thw = np.array([grid])
    with torch.no_grad():
        hs = hf_model(input_ids=torch.from_numpy(ids), pixel_values_videos=torch.from_numpy(patches),
                      video_grid_thw=torch.from_numpy(grid_thw), second_per_grid_ts=torch.tensor([1.0]),
                      output_hidden_states=True).hidden_states
        pos, _ = get_rope_index(cfg, ids, video_grid_thw=grid_thw, second_per_grid_ts=[1.0])
        vis = VisionInputs.build(prepare_vision_inputs([grid], cfg.vision), torch.from_numpy(patches))
        ids_t = torch.from_numpy(ids)
        feats = vision_forward(params["visual"], cfg.vision, *vis)
        embeds = merge_vision_embeddings(embed_lookup(params["text"]["embed_tokens"], ids_t), ids_t, feats,
                                         (cfg.video_token_id, cfg.image_token_id))
        final, _, per_layer = decoder_forward(params["text"], cfg.text, embeds, torch.from_numpy(pos),
                                              collect_hiddens=True)
    args = parity.get_args(["--model_base", "m"])
    L = cfg.text.num_hidden_layers
    for l in range(L):  # HF's last slot is after the final norm
        ours, want = (final if l == L - 1 else per_layer[l]).numpy(), hs[l + 1].numpy()
        assert np.abs(ours - want).max() <= args.atol + args.rtol * np.abs(want).max(), l


def test_oracle_given_the_ports_positions_is_hfs_own(hf_model):  # noqa: F811
    """The harness hands HF the port's M-RoPE position ids (transformers 5.x
    computes other ones for a video); under transformers 4.x, whose own are
    the reference's, the oracle's logits and hidden states are unchanged by
    it, to the bit."""
    from time_r1_tpu_torch.models.qwen25vl import get_rope_index

    grid = (4, 6, 8)
    patches = np.random.default_rng(2).normal(size=(192, CFG.vision.patch_input_dim)).astype(np.float32)
    ids = parity._fixed_prompt(CFG, grid)
    pos, _ = get_rope_index(CFG, ids, video_grid_thw=np.array([grid]), second_per_grid_ts=[1.0])
    kw = dict(input_ids=torch.from_numpy(ids), pixel_values_videos=torch.from_numpy(patches),
              video_grid_thw=torch.tensor([grid]), second_per_grid_ts=torch.tensor([1.0]), output_hidden_states=True)
    with torch.no_grad():
        own = hf_model(**kw)
        given = hf_model(position_ids=torch.from_numpy(pos).long(), **kw)
    torch.testing.assert_close(given.logits, own.logits, atol=0, rtol=0)
    for a, b in zip(given.hidden_states, own.hidden_states):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("path", ["cache", "cp", "shard", "lora_side"])
def test_collect_hiddens_refuses_other_paths(path):
    from test_torch_bridge import jax_params, port_params
    from time_r1_tpu_torch.models.qwen25vl import KVCache, decoder_forward

    p = port_params(jax_params())
    hidden, pos, _ = _decoder_inputs(B=1, S=8)
    kw = {
        "cache": KVCache.zeros(CFG.text, 1, 16, dtype=torch.float32, device="cpu"),
        "cp": object(),
        "shard": object(),
        "lora_side": ([], 1.0),
    }
    with pytest.raises(ValueError, match="collect_hiddens takes the no-cache forward only"):
        decoder_forward(p["text"], CFG.text, torch.from_numpy(hidden), torch.from_numpy(pos),
                        collect_hiddens=True, **{path: kw[path]})


# ---------------------------------------------------------------------------
# the ROUGE-L diversity reward
WORDS = ("running", "runs", "ran", "chair", "chairs", "sitting", "sits", "person", "the", "a", "door",
         "opening", "opens", "12.5", "to", "17.83", "<think>", "</think>", "Quickly", "QUICK", "stood")


def _completions(seed, n):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(0, 14)))) for _ in range(n)]


@pytest.mark.parametrize("G", [2, 4, 8])
@pytest.mark.parametrize("use_stemmer", [True, False])
def test_rouge_l_equal_to_jax(G, use_stemmer):
    texts = _completions(G, 2 * G)
    for a in texts:
        for b in texts:
            assert rewards.rouge_l_fmeasure(a, b, use_stemmer) == jax_rewards.rouge_l_fmeasure(a, b, use_stemmer)
    got = rewards.diversity_reward_func(texts, num_generations=G)
    assert got == jax_rewards.diversity_reward_func(texts, num_generations=G)
    assert len(got) == 2 * G and all(0.0 <= r <= 1.0 for r in got)
    assert "diversity" not in str(rewards.REWARD_FUNCS_REGISTRY)  # no registry names it, as in JAX


def test_stemmer_import_error_surfaces():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "nltk.stem", None)  # `from nltk.stem import porter` raises ImportError
        rewards._porter.cache_clear()
        jax_rewards._PORTER_CACHE.clear()
        try:
            with pytest.raises(ImportError):
                rewards.rouge_l_fmeasure("the chairs", "a chair")
            # JAX returns the tokens unstemmed: "chairs" and "chair" then differ
            assert jax_rewards.rouge_l_fmeasure("the chairs", "a chair") == 0.0
        finally:
            rewards._porter.cache_clear()
            jax_rewards._PORTER_CACHE.clear()
    pair = ("the chairs", "a chair")
    assert rewards.rouge_l_fmeasure(*pair) == jax_rewards.rouge_l_fmeasure(*pair) == 0.5


# ---------------------------------------------------------------------------
# the profiling helpers
def test_phase_timers_write_and_reset(tmp_path):
    mine, ref = profiling.PhaseTimers(sync=False), jax_profiling.PhaseTimers(sync=False)
    for t in (mine, ref):
        t.totals.update({"rollout": 1.25, "train_step": 0.5})
        t.counts.update({"rollout": 2, "train_step": 1})
    mine.write(str(tmp_path / "mine.json"))
    ref.write(str(tmp_path / "ref.json"))
    assert (tmp_path / "mine.json").read_text() == (tmp_path / "ref.json").read_text()
    assert json.loads((tmp_path / "mine.json").read_text()) == mine.summary()
    mine.reset()
    assert mine.summary() == {} and not mine.counts
    with mine.phase("decode"):
        pass
    assert mine.counts == {"decode": 1}
    assert isinstance(profiling.GLOBAL_TIMERS, profiling.PhaseTimers)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(8).add_(1)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "t" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    for empty in (None, ""):
        with profiling.trace(empty):
            pass
    assert os.listdir(tmp_path) == ["t"]


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 18 checkpoint, at the tiny widths
@pytest.mark.parametrize("tied", [True, False])
def test_chip_phase_checkpoint_passes_the_harness(tied, tmp_path):
    """`chip_smoke.hf_parity_checkpoint` (transformers' own initialisation,
    save_pretrained in bf16, the ids at the top level) read by the port's HF
    loader through the harness: a tied head and an untied one, as the 3B and
    the 7B of phase 18."""
    import dataclasses

    import chip_smoke
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig.tiny_test(256)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tie_word_embeddings=tied))
    ckpt = str(tmp_path / "ckpt")
    assert chip_smoke.hf_parity_checkpoint(cfg, ckpt, device="cpu") > 0
    with open(os.path.join(ckpt, "config.json")) as f:
        written = json.load(f)
    assert written["video_token_id"] == cfg.video_token_id and written["tie_word_embeddings"] is tied
    from safetensors import safe_open

    names = set()
    for fname in os.listdir(ckpt):
        if fname.endswith(".safetensors"):
            with safe_open(os.path.join(ckpt, fname), "pt") as f:
                names |= set(f.keys())
                assert all(f.get_tensor(k).dtype == torch.bfloat16 for k in f.keys())
    assert ("lm_head.weight" in names) is not tied
    args = parity.get_args(["--model_base", ckpt, "--output_dir", str(tmp_path / "out"), "--skip_demo",
                            "--skip_benchmark"])
    assert parity.main(args, device="cpu") == 0
    assert _report(tmp_path / "out")["activations"]["status"] == "pass"
