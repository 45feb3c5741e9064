"""The port's benchmark loaders (`time_r1_tpu_torch/data/loaders.py`) against
the JAX package's, over tests/test_loaders.py's synthetic fixture trees
(and the formats that file leaves out: egoschema, tvgbench_filter): every
loader's rows equal, with the qids, paths and option parsing that file
checks, plus `load_datasets`, `split_data` and the loader table."""

import json
import os

import pytest

import time_r1_tpu.data.loaders as JL
import time_r1_tpu_torch.data.loaders as L


@pytest.fixture()
def data_root(tmp_path, monkeypatch):
    monkeypatch.setattr(L, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(JL, "DATA_ROOT", str(tmp_path))
    return tmp_path


def _touch(path):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00")


def _same(name, *args, **kwargs):
    got = getattr(L, name)(*args, **kwargs)
    assert got == getattr(JL, name)(*args, **kwargs)
    return got


def test_loader_table_matches():
    assert list(L.LOADERS) == list(JL.LOADERS)
    assert L.TG_DATASET_NAMES == JL.TG_DATASET_NAMES and L.MCQ_DATASET_NAMES == JL.MCQ_DATASET_NAMES
    assert L.MVBENCH_VIDEO_DIRS == JL.MVBENCH_VIDEO_DIRS
    assert L.DATA_ROOT == JL.DATA_ROOT


def test_load_charades_txt_csv_conversion(data_root):
    anno = data_root / "charades" / "Charades_anno"
    anno.mkdir(parents=True)
    (anno / "Charades_sta_test.txt").write_text(
        "V1 1.0 3.5##person opens a door.\nV1 4.0 6.0##person sits down.\nV2 0.5 2.0##person runs.\n")
    (anno / "Charades_v1_test.csv").write_text("id,length\nV1,10.0\nV2,8.5\n")
    out = L.load_charades("test")  # builds the json cache
    assert [o["qid"] for o in out] == ["charades_0", "charades_1", "charades_2"]
    assert out[0]["timestamp"] == [1.0, 3.5] and out[0]["duration"] == 10.0
    assert out[2]["video"].endswith("Charades_v1/V2.mp4")
    assert (anno / "Charades_sta_test.json").exists()
    assert _same("load_charades", "test") == out  # from the cache, both packages
    (anno / "Charades_sta_test.json").unlink()
    assert JL.load_charades("test") == out  # JAX's conversion writes the same rows


def test_load_activitynet(data_root):
    ann_dir = data_root / "activitynet" / "annotations" / "sentence_temporal_grounding"
    ann_dir.mkdir(parents=True)
    _touch(data_root / "activitynet" / "videos" / "vid1.mkv")
    _touch(data_root / "activitynet" / "videos" / "vid2.mp4")
    (ann_dir / "test.json").write_text(json.dumps({
        "vid1": {"duration": 12.0, "timestamps": [[0, 4], [5, 9]], "sentences": ["a ", "b"]},
        "vid2": {"duration": 3.0, "timestamps": [[1, 2]], "sentences": [" c"]},
    }))
    out = _same("load_activitynet", "test")
    assert [o["qid"] for o in out] == ["activitynet_0", "activitynet_1", "activitynet_2"]
    assert out[0]["video"].endswith("vid1.mkv") and out[2]["video"].endswith("vid2.mp4")
    assert out[0]["sentence"] == "a" and out[2]["sentence"] == "c"


def test_load_tempcompass_splits(data_root):
    qdir = data_root / "tempcompass" / "questions"
    qdir.mkdir(parents=True)
    (qdir / "multi-choice.json").write_text(json.dumps(
        {"vid": {"order": [{"question": "What happens first?\nA. run\nB. sit", "answer": "B. sit"}]}}))
    (qdir / "yes_no.json").write_text(json.dumps({"vid": {"order": [{"question": "Is it day?", "answer": "no"}]}}))
    (qdir / "caption_matching.json").write_text(json.dumps({"vid": {"speed": [
        {"question": "Which caption?\nCaption A: fast run\nCaption B: slow walk", "answer": "Caption B: slow walk"}]}}))
    (qdir / "captioning.json").write_text(json.dumps({"vid": {"order": [{"question": "Describe.", "answer": "x"}]}}))
    mc = _same("load_tempcompass", "multi-choice")
    assert mc[0]["options"] == ["run", "sit"] and mc[0]["answer"] == 1
    assert mc[0]["qid"] == "tempcompass|multi-choice|vid|order|0"
    assert _same("load_tempcompass", "test") == mc
    yn = _same("load_tempcompass", "yes_no")
    assert yn[0]["options"] == ["yes", "no"] and yn[0]["answer"] == 1
    cm = _same("load_tempcompass", "caption_matching")
    assert cm[0]["options"] == ["fast run", "slow walk"] and cm[0]["answer"] == 1
    cap = _same("load_tempcompass", "captioning")
    assert cap[0]["options"] == [] and cap[0]["answer"] == "x"


def test_load_mvbench_split_clips(data_root):
    jdir = data_root / "mvbench" / "json"
    jdir.mkdir(parents=True)
    (jdir / "action_localization.json").write_text(json.dumps([
        {"video": "clip.mp4", "question": "q?", "candidates": ["x", "y"], "answer": "y", "start": 2.5, "end": 7.0}]))
    (jdir / "action_count.json").write_text(json.dumps([
        {"video": "v.mp4", "question": "n?", "candidates": ["1", "2"], "answer": "1"},
        {"video": "w.mp4", "question": "m?", "candidates": ["1", "2"], "answer": "2", "start": 1.5}]))
    out = _same("load_mvbench")
    by_qid = {o["qid"]: o for o in out}
    clip = by_qid["mvbench|action_localization|0"]
    assert clip["video"].endswith("sta/sta_video/split/clip_2-5_7-0.mp4") and clip["answer"] == 1
    plain = by_qid["mvbench|action_count|0"]
    assert plain["video"].endswith("perception/videos/v.mp4") and plain["answer"] == 0
    assert by_qid["mvbench|action_count|1"]["video_start"] == 1.5


def _parquet(path, rows):
    import pandas as pd

    path.parent.mkdir(parents=True)
    pd.DataFrame(rows).to_parquet(path)


def test_load_videomme_parquet(data_root):
    _parquet(data_root / "videomme" / "videomme" / "test-00000.parquet", [
        {"videoID": "abc", "question": "what?", "options": ["A. one", "B. two"], "answer": "B",
         "duration": "short", "question_id": "001-1"},
        {"videoID": "def", "question": "who?", "options": ["A. x", "B. y"], "answer": "A",
         "duration": "long", "question_id": "002-1"},
    ])
    out = _same("load_videomme", "default")
    assert len(out) == 2 and out[0]["qid"] == "videomme_001-1"
    assert out[0]["options"] == ["one", "two"] and out[0]["answer"] == 1
    short = _same("load_videomme", "short")
    assert len(short) == 1 and short[0]["qid"] == "videomme_001-1"
    assert _same("load_videomme", "test") == out


def test_load_egoschema_parquet(data_root):
    row = {"video_idx": "e1", "question": "why?", "option": ["A. p", "B. q", "C. r"], "answer": 2,
           "question_idx": "q7"}
    _parquet(data_root / "egoschema" / "MC" / "part-0.parquet", [row])
    _parquet(data_root / "egoschema" / "Subset" / "part-0.parquet", [dict(row, question_idx="q8")])
    out = _same("load_egoschema")
    assert out[0]["qid"] == "egoschema_q7" and out[0]["options"] == ["p", "q", "r"] and out[0]["answer"] == 2
    assert out[0]["video"].endswith("egoschema/videos/e1.mp4")
    assert _same("load_egoschema", "subset")[0]["qid"] == "egoschema_q8"


def test_load_tvgbench_answer_parse(data_root, tmp_path):
    video = tmp_path / "real.mp4"
    _touch(video)
    ann_dir = data_root / "timer1" / "annotations"
    ann_dir.mkdir(parents=True)
    (ann_dir / "tvgbench.json").write_text(json.dumps([
        {"path": str(video), "duration": 30.0, "answer": "3.5-9.25", "question": "the event", "start": 0,
         "end": 30, "source": "data/qv-highlights.json"},
        {"path": "/missing.mp4", "duration": 1, "answer": "0-1", "question": "x", "start": 0, "end": 1},
        {"path": str(video), "duration": 30.0, "answer": "1-2", "question": "another"},
    ]))
    out = _same("load_tvgbench")
    assert len(out) == 2  # the missing video is skipped
    assert out[0]["timestamp"] == [3.5, 9.25]
    assert [o["qid"] for o in out] == ["qv_highlights_0", "qv_highlights_1"]


def test_load_tvgbench_filter_and_datasets(data_root, tmp_path):
    rows = [{"video": "a.mp4", "duration": 9.0, "timestamp": [1, 2], "sentence": "s", "qid": "x_0", "pred": [1, 3],
             "video_start": 0.5, "extra": 1},
            {"video": "b.mp4", "duration": 4.0, "timestamp": [0, 1], "sentence": "t", "qid": "x_1"}]
    path = tmp_path / "filter.json"
    path.write_text(json.dumps(rows))
    out = _same("load_tvgbench_filter", str(path))
    assert out[0]["pred"] == [1, 3] and out[1]["video_end"] is None and "extra" not in out[0]
    both = _same("load_datasets", ["tvgbench_filter", "tvgbench_filter"], split=str(path))
    assert len(both) == 4
    assert _same("load_datasets", "tvgbench_filter", split=str(path)) == out
    for n, k in [(10, 3), (7, 2), (1, 4), (0, 2)]:
        data = list(range(n))
        for i in range(k):
            assert L.split_data(data, i, k) == JL.split_data(data, i, k)
        assert sum((L.split_data(data, i, k) for i in range(k)), []) == data
