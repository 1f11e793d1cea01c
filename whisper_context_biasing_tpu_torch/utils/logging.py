"""Structured run logging.

The reference logs through print + wandb (report_to=["wandb"],
scripts/train.py:256). Here the primary sink is a step-indexed jsonl file
(machine-readable, offline-first); wandb/TensorBoard are optional mirrors
enabled only when their packages and endpoints exist.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class RunLogger:
    """jsonl event log + optional wandb/tensorboard mirrors."""

    def __init__(
        self,
        output_dir: str,
        filename: str = "train_log.jsonl",
        use_wandb: bool = False,
        wandb_project: str | None = None,
        use_tensorboard: bool = False,
        echo: bool = True,
    ):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._f = open(self.path, "a", encoding="utf-8")
        self.echo = echo
        self._t0 = time.time()

        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project or "whisper-biasing-tpu",
                                         dir=output_dir)
            except Exception as e:  # offline / not installed
                print(f"[logger] wandb disabled: {e}")

        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
            except Exception as e:
                print(f"[logger] tensorboard disabled: {e}")

    def log(self, event: dict[str, Any], step: int | None = None) -> None:
        entry = dict(event)
        if step is not None:
            entry.setdefault("step", step)
        entry.setdefault("wall_s", round(time.time() - self._t0, 2))
        self._f.write(json.dumps(entry) + "\n")
        self._f.flush()
        if self.echo:
            print(json.dumps(entry))
        if self._wandb is not None:
            scalars = {k: v for k, v in entry.items() if isinstance(v, (int, float))}
            self._wandb.log(scalars, step=entry.get("step"))
        if self._tb is not None and "step" in entry:
            for k, v in entry.items():
                if isinstance(v, (int, float)) and k != "step":
                    self._tb.add_scalar(k, v, entry["step"])

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
