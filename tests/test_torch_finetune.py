"""The fine-tuning entry points against the JAX package's, on the CPU:

- `cli.finetune.load_json_dataset` gives JAX's examples from a
  Charades-style json under the same `random.seed(42)` (sentences
  normalized, one example per sentence, the video found by extension or
  None, the preprocessed path per video id);
- `cli.preprocess_videos.process_split` over clips written with OpenCV
  (tests/test_torch_video.py::write_clip) writes the `video.npz` (frames
  bit-equal) and `video_kwargs.json` that JAX's writes, with 1 and 2 worker
  processes, over dict and list annotations; it skips a video whose
  directory exists, reports a missing video and counts one that fails to
  decode without stopping the others;
- `cli.finetune.main` on the tiny config (HF checkpoint, `--beta 0.0
  --use_grpo false`, the recipe's flags) trains from the npz files with the
  decoder patched to raise: no reference copy, one update, a final
  checkpoint that reloads equal to the trained weights (its
  `--tensor_parallel_size 2` run is in tests/test_torch_sharded_trainer.py)."""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax

from test_torch_train_cli import _hf_checkpoint, tiny_processor  # noqa: F401  (a fixture)
from test_torch_video import jax_native_libs, write_clip
from time_r1_tpu.cli import finetune as jax_finetune
from time_r1_tpu.cli import preprocess_videos as jax_pre
from time_r1_tpu_torch.cli import finetune
from time_r1_tpu_torch.cli import preprocess_videos as pre
from time_r1_tpu_torch.models.qwen25vl import convert as conv
from time_r1_tpu_torch.video import pipeline

torch.set_num_threads(2)

PIXELS = (8 * 28 * 28, 4 * 28 * 28)  # total and min pixels: 8-frame clips of the tiny config's size


def _charades(tmp_path, ids=("vid_a", "vid_b")):
    data = {
        ids[0]: {"duration": 3.0, "timestamps": [[0.5, 1.5], [1.0, 2.5]],
                 "sentences": [" A person Sits down. ", "someone opens a door."]},
        ids[1]: {"duration": 3.0, "timestamps": [[0.0, 2.0]], "sentences": ["The light turns on"]},
    }
    path = tmp_path / "charades.json"
    path.write_text(json.dumps(data))
    return str(path)


@pytest.mark.parametrize("preprocessed", [False, True])
def test_load_json_dataset_matches_jax(tmp_path, preprocessed):
    videos = tmp_path / "videos"
    videos.mkdir()
    (videos / "vid_a.mkv").write_bytes(b"placeholder")  # vid_b has no file: video_path None
    pp = str(tmp_path / "pre") if preprocessed else ""
    if preprocessed:
        os.makedirs(os.path.join(pp, "vid_a"))
    path = _charades(tmp_path)
    random.seed(42)
    got = finetune.load_json_dataset(path, str(videos), pp)
    random.seed(42)
    want = jax_finetune.load_json_dataset(path, str(videos), pp)
    assert got == want and len(got) == 3
    assert {e["problem"] for e in got} == {"a person sits down", "someone opens a door", "the light turns on"}
    assert {e["video_path"] for e in got} == {str(videos / "vid_a.mkv"), None}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    jax_native_libs()
    d = tmp_path_factory.mktemp("finetune_clips")
    return str(d), [write_clip(d / "vid_a.mp4", frames=24, seed=0), write_clip(d / "vid_b.mp4", frames=16, seed=1)]


def _read(out_dir, vid):
    with np.load(os.path.join(out_dir, vid, "video.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(out_dir, vid, "video_kwargs.json")) as f:
        return arrays, json.load(f)


@pytest.mark.parametrize("workers", [1, 2])
def test_preprocess_videos_matches_jax(tmp_path, clips, workers):
    folder, _ = clips
    ann = _charades(tmp_path)
    got = pre.process_split(ann, folder, str(tmp_path / "port"), *PIXELS, num_workers=workers)
    want = jax_pre.process_split(ann, folder, str(tmp_path / "jax"), *PIXELS, num_workers=workers)
    assert sorted(r["preprocessed_path"] for r in got) == sorted(str(tmp_path / "port" / v) for v in ("vid_a", "vid_b"))
    assert len(want) == 2
    for vid in ("vid_a", "vid_b"):
        (a, ka), (b, kb) = _read(str(tmp_path / "port"), vid), _read(str(tmp_path / "jax"), vid)
        assert sorted(a) == sorted(b) == ["fps", "video"] and ka == kb
        assert a["video"].dtype == np.float32 and a["video"].ndim == 4 and a["video"].shape[1] == 3  # TCHW
        assert np.array_equal(a["video"], b["video"]) and float(a["fps"]) == float(b["fps"]) == ka["fps"][0]


def test_preprocess_skips_what_exists_and_survives_failures(tmp_path, clips, capsys):
    folder, paths = clips
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"not a video")
    # list format: an id found in the folder, a path, a broken file and an id with no file
    ann = tmp_path / "list.json"
    ann.write_text(json.dumps([{"video": "vid_a"}, {"video": paths[1]}, {"video": str(bad)}, {"video": "nowhere"}]))
    out = tmp_path / "out"
    os.makedirs(out / "vid_b")  # already there: skipped, never decoded
    ok = pre.process_split(str(ann), folder, str(out), *PIXELS, num_workers=1)
    printed = capsys.readouterr().out
    assert sorted(r["preprocessed_path"] for r in ok) == [str(out / "vid_a"), str(out / "vid_b")]
    assert os.listdir(out / "vid_b") == [] and not os.path.exists(out / "broken")
    assert "Video file not found for ID: nowhere" in printed and "Failed: 1, Successful: 2" in printed
    want = jax_pre.process_split(str(ann), folder, str(tmp_path / "jax"), *PIXELS, num_workers=1)
    assert len(want) == 2  # vid_a and vid_b (new to JAX's output), the broken one failed
    assert np.array_equal(_read(str(out), "vid_a")[0]["video"], _read(str(tmp_path / "jax"), "vid_a")[0]["video"])


def test_main_trains_from_the_npz_files(tmp_path, clips, tiny_processor, monkeypatch):  # noqa: F811
    folder, _ = clips
    ann = _charades(tmp_path)
    pp = tmp_path / "pre"
    pre.main(["--train_data_path", ann, "--video_folder", folder, "--output_dir", str(pp),
              "--max_pix_size", "8", "--min_pix_size", "4", "--num_workers", "1"])

    def no_decode(*args, **kwargs):
        raise AssertionError("the decoder ran: the npz files were not used")

    monkeypatch.setattr(pipeline, "fetch_video", no_decode)
    monkeypatch.setattr(finetune, "video_loader", no_decode)
    sinks = []
    monkeypatch.setattr("time_r1_tpu_torch.utils.logging_sinks.TensorBoardSink",
                        lambda logdir: sinks.append(logdir) or type("Sink", (), {"log": lambda *a: None,
                                                                              "close": lambda *a: None})())
    loads = []
    real_load = finetune.load_checkpoint
    monkeypatch.setattr(finetune, "load_checkpoint", lambda *a, **kw: loads.append(a) or real_load(*a, **kw))
    out = tmp_path / "run"
    tr = finetune.main(["--model_name_or_path", _hf_checkpoint(tmp_path / "hf"), "--output_dir", str(out),
                        "--train_data_path", ann, "--video_folder", folder, "--preprocessed_data_path", str(pp),
                        "--beta", "0.0", "--use_grpo", "false", "--num_generations", "2",
                        "--max_completion_length", "4", "--num_train_epochs", "1", "--learning_rate", "1e-3",
                        "--reward_funcs", "iou", "format"], device="cpu")
    assert len(loads) == 1 and tr.ref_params is None and not tr.hp.use_grpo and tr.hp.beta == 0.0
    assert tr.global_step == 3 and tr.opt_state.count == 1  # 3 examples at accumulation 2
    assert sinks == [str(out / "tb")]  # JAX's TrainConfig: the default tensorboard sink
    saved, cfg = conv.load_checkpoint(str(out), device="cpu")
    assert cfg == tr.cfg
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(tr.params)):
        assert torch.equal(a, b.detach())
    assert sorted(d for d in os.listdir(out) if d.startswith("epoch")) == ["epoch-1"]
