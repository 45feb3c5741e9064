#!/usr/bin/env python3
"""Does `chip_smoke.StepWindow` see every kernel of its window? Qwen2.5-VL-3B
in bf16 with seeded random weights, phase 5's G = 8 rollout (64 new tokens),
16 steady decode steps (32-47) under torch.profiler, eager and captured in
turns, six turns each: D2's launches by name in each window (36 a step, 576
in all), its device records and idle share, or the loss of a marker
(`chip_smoke.WindowLost`); then one `settled_window` of each mode, as phase
5 reads it. With a path to another checkout (e.g. the parent unpacked with
`git archive` into a gitignored directory), that checkout's `StepWindow`
takes its turn beside this tree's on the same engine. It reports what the
profiler saw and fails only if a settled window is short of 576 D2. Needs a
CUDA device and nvcc; exits 2 without a card.

    python3 scripts/check_profile_window.py [OTHER]
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # as chip_smoke.py's main

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

TURNS = 6


def other_window(root: str):
    spec = importlib.util.spec_from_file_location("other_chip_smoke", Path(root) / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.StepWindow


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.sampler import Engine, SamplingParams

    windows = [("this tree", chip_smoke.StepWindow)]
    if len(sys.argv) > 1:
        windows.insert(0, (sys.argv[1], other_window(sys.argv[1])))
    card = chip_smoke.card_line()
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    cfg = Qwen25VLConfig.qwen25vl_3b()
    want = 16 * cfg.text.num_hidden_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    req = chip_smoke.video_request(cfg, np.random.default_rng(0), 32, 224, 392)
    sp = SamplingParams(temperature=1.0, max_new_tokens=64, stop_token_ids=(), num_return_sequences=8, seed=0)
    rows = []

    def decode(mode):
        if mode == "eager":
            with chip_smoke.eager_decode():
                eng.generate([req], sp)
        else:
            eng.generate([req], sp)

    with torch.no_grad():
        eng = Engine(params, cfg, dtype=torch.bfloat16, device="cuda")
        eng.generate([req], sp)
        for turn in range(TURNS):
            for mode in ("eager", "captured"):
                for which, window in windows:
                    try:
                        with window(first=32, count=16) as win:
                            decode(mode)
                    except chip_smoke.WindowLost as lost:
                        row = dict(turn=turn, mode=mode, window=which, d2=None, marker_lost=str(lost))
                        chip_smoke.log(json.dumps(row))
                        rows.append(row)
                        continue
                    st = win.stats()
                    row = dict(turn=turn, mode=mode, window=which, d2=win.kernels("decode_full_tc"),
                               device_events=st["device_events"], idle_share=st["idle_share"], span_ms=st["span_ms"])
                    if row["d2"] != want:
                        names = [n[:40] for n, _, _ in sorted(win.events, key=lambda e: e[1])]
                        row["first_events"], row["last_events"] = names[:5], names[-5:]
                    chip_smoke.log(json.dumps(row))
                    rows.append(row)
        settled = {}
        for mode in ("eager", "captured"):
            win, seen = chip_smoke.settled_window(lambda: decode(mode), first=32, count=16)
            settled[mode] = dict(d2=win.kernels("decode_full_tc"), windows_records=seen,
                                 idle_share=win.stats()["idle_share"])
            chip_smoke.log(f"settled window, {mode}: {settled[mode]}")
    short = {f"{which}, {mode}": sum(r["d2"] != want for r in rows if r["window"] == which and r["mode"] == mode)
             for which, _ in windows for mode in ("eager", "captured")}
    records = {f"{which}, {mode}": sorted({r["device_events"] for r in rows
                                           if r["window"] == which and r["mode"] == mode and r["d2"] is not None})
               for which, _ in windows for mode in ("eager", "captured")}
    print(card, flush=True)
    print(json.dumps({"windows_short_of_576_d2": short, "of": TURNS, "records_seen": records, "settled": settled,
                      "rows": rows}), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0 if all(v["d2"] == want for v in settled.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
