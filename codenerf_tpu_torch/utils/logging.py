"""Metrics logging: JSONL always, TensorBoard when it imports (the port's
copy of ``codenerf_tpu/utils/logging.py``).

Scalar names follow the reference's TensorBoard schema (``psnr/train``,
``time/train``, ``reg/train``, ``src/trainer.py:101-107``); the JSONL
stream ``metrics.jsonl`` in the run dir is the machine-readable record.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

from codenerf_tpu_torch.utils.images import save_png


class MetricsLogger:
    def __init__(self, run_dir: str, use_tensorboard: bool = False):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "runs"))
            except Exception:
                self._tb = None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def image(self, step: int, tag: str, img_u8) -> None:
        save_png(os.path.join(self.run_dir, f"{tag}_{step}.png"), img_u8)
        if self._tb is not None:
            import numpy as np

            self._tb.add_image(tag, np.transpose(img_u8, (2, 0, 1)), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
