#!/usr/bin/env python3
"""The parity harness against HF transformers on one card, at the 3B's and
the 7B's full widths.

    python3 scripts/check_parity.py [a] [b]

(a) `chip_smoke.py`'s phase 18 alone (after the kernel build): the 3B and the
    7B at PARITY_LAYERS decoder layers and PARITY_VISION_DEPTH vision blocks
    through `cli.parity.main`, with the K2 / K3 launch counts.
(b) the 3B and the 7B at FULL depth (36 / 28 decoder layers, 32 vision
    blocks), each an HF checkpoint that transformers initialises from a seed
    and writes in bf16 (`chip_smoke.hf_parity_checkpoint`), then

        python -m time_r1_tpu_torch.cli.parity --model_base <dir> --skip_demo --skip_benchmark

    in a subprocess, as users run it: both sides in f32 on the card, one
    after the other (the 7B in f32 is ~33 GB a side), then the port in bf16.
    Prints each layer's max|Δ|, the logits', the bf16 argmax agreement and
    the seconds. Writes up to 17 GB under the temporary directory (TMPDIR),
    one checkpoint at a time, and refuses to start one with less than
    FREE_GB free; deletes each afterwards.

Both by default. Prints the card's name and power limit first. Needs a CUDA
device, nvcc and transformers; exits 2 without a CUDA device. Exit 1 when a
check fails.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # as chip_smoke.main

import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

FREE_GB = 20  # the 7B's bf16 checkpoint is 16.6 GB
FULL_TIMEOUT = 1200  # s: one subprocess's limit (the 7B: read 16.6 GB twice, 33 GB a side on the card)


def full_depth(card: str, name: str) -> dict:
    cfg = chip_smoke.parity_config(name)
    root = tempfile.mkdtemp(prefix=f"timer1_parity_{name}_")
    try:
        free = shutil.disk_usage(root).free / 1e9
        if free < FREE_GB:
            raise RuntimeError(f"(b) {name}: {free:.1f} GB free under {root}, want {FREE_GB}")
        ckpt, out = os.path.join(root, "ckpt"), os.path.join(root, "out")
        t0 = time.perf_counter()
        gb = chip_smoke.hf_parity_checkpoint(cfg, ckpt)
        write_s = time.perf_counter() - t0
        chip_smoke.log(f"[parity full {name}] transformers wrote {gb:.2f} GB ({cfg.text.num_hidden_layers} decoder "
                       f"layers, {cfg.vision.depth} vision blocks, tied head {cfg.text.tie_word_embeddings}) in "
                       f"{write_s:.1f} s; {free:.1f} GB were free")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "time_r1_tpu_torch.cli.parity", "--model_base", ckpt, "--output_dir", out,
             "--skip_demo", "--skip_benchmark"],
            cwd=REPO, capture_output=True, text=True, timeout=FULL_TIMEOUT,
        )
        seconds = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            chip_smoke.log(f"[parity full {name}] {line}")
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-8000:])
            raise AssertionError(f"(b) {name}: cli.parity exited {proc.returncode}")
        with open(os.path.join(out, "parity_report.json")) as f:
            report = json.load(f)["activations"]
        if report["status"] != "pass":
            raise AssertionError(f"(b) {name}: activations {report['status']!r}")
        chip_smoke.log(f"[parity full {name}] the command: {seconds:.1f} s (HF oracle and port both in f32 on the "
                       f"card, one after the other, then the port in bf16); {card}")
        return {"write_s": write_s, "seconds": seconds, "gb": gb, "detail": report["detail"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(parts: str) -> int:
    if not torch.cuda.is_available():
        print("check_parity: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import transformers

    card = chip_smoke.card_line()
    chip_smoke.log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} transformers "
                   f"{transformers.__version__}; {card}")
    chip_smoke.phase_build()
    if "a" in parts:
        chip_smoke.timed(chip_smoke.phase_parity, card)
    if "b" in parts:
        for name in chip_smoke.PARITY_MODELS:
            full_depth(card, name)
    return 0


if __name__ == "__main__":
    sys.exit(main("".join(sys.argv[1:]) or "ab"))
