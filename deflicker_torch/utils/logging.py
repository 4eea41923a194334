"""Scalar logging / observability.

The reference logs through TensorBoard's SummaryWriter
(src/stage1_neural_atlas.py:104) plus prints.  We write newline-delimited
JSON (scalars.jsonl) — greppable, dependency-free — and mirror into
TensorBoard when `tensorboard` is importable.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Mapping


class ScalarLogger:
    def __init__(self, log_dir: str | Path, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.log_dir / "scalars.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

                self._tb = SummaryWriter(log_dir=str(self.log_dir))
            except Exception:
                self._tb = None

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_image(self, step: int, tag: str, image) -> None:
        """TensorBoard image (HWC float [0,1]), like the reference's
        evaluator images (evaluate.py:589-600,784-793).  No-op without TB."""
        if self._tb is not None:
            import numpy as np

            img = np.clip(np.asarray(image), 0.0, 1.0)
            self._tb.add_image(tag, img.transpose(2, 0, 1), int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
