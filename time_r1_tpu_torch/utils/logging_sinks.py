"""Metric sinks (a copy of `time_r1_tpu/utils/logging_sinks.py`: the port
imports nothing of the JAX package, not even its jax-free modules).

- TensorBoardSink: scalar metrics per global step (torch's SummaryWriter,
  which needs the `tensorboard` package; without it the trainer goes on
  without this sink and says so).
- WandbSink: the wandb client when it is installed, else an offline jsonl
  file with the same per-step payloads.
- DebugRewardLog: the reference's DEBUG_MODE/LOG_PATH append-file oracle
  (main.py:171-179): every completion/pred/gt/reward.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict


class TensorBoardSink:
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir=log_dir)

    def log(self, metrics: Dict[str, float], step: int):
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, step)
        self.writer.flush()

    def close(self):
        self.writer.close()


class WandbSink:
    """--report_to wandb (reference recipes set WANDB_* env and HF Trainer
    reports there, scripts/posttrain/train_rl.sh:3). Uses the wandb client
    when importable; otherwise degrades to an offline jsonl run file
    (wandb/offline-run.jsonl under the log dir) with the same per-step
    payloads — nothing is silently dropped on hosts without the package."""

    def __init__(self, log_dir: str, run_name: str = ""):
        self._run = None
        self._fh = None
        try:
            import wandb  # not in the baked image; real sink when present

            self._run = wandb.init(
                project=os.getenv("WANDB_PROJECT", "time-r1-tpu"),
                name=run_name or None,
                dir=log_dir,
                resume="allow",
            )
        except ImportError:
            path = os.path.join(log_dir, "wandb")
            os.makedirs(path, exist_ok=True)
            self._fh = open(os.path.join(path, "offline-run.jsonl"), "a", encoding="utf-8")

    def log(self, metrics: Dict[str, float], step: int):
        payload = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
        if self._run is not None:
            self._run.log(payload, step=step)
        else:
            import json

            self._fh.write(json.dumps({"step": step, **payload}) + "\n")
            self._fh.flush()

    def close(self):
        if self._run is not None:
            self._run.finish()
        if self._fh is not None:
            self._fh.close()


class DebugRewardLog:
    """Active when DEBUG_MODE=true and LOG_PATH are set (reference parity)."""

    def __init__(self):
        self.enabled = os.getenv("DEBUG_MODE") == "true" and bool(os.getenv("LOG_PATH"))
        self.path = os.getenv("LOG_PATH")

    def log_reward(self, content: str, pred, gt, reward: float, name: str = "IoU"):
        if not self.enabled:
            return
        stamp = datetime.now().strftime("%d-%H-%M-%S-%f")
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(f"Content: {content}\n")
            f.write(f"pred second: {pred}\n")
            f.write(f"gt second: {gt}\n")
            f.write(f"------------- {stamp} {name} reward: {reward} -------------\n")
