"""Training metrics: one JSON line per logged step, and tensorboard scalars
where ``tensorboardX`` is installed.

Counterpart of ``gencomm_tpu/train/metrics.py``: the same file,
``<model_dir>/metrics.jsonl``, and the same line format,
``{"step": N, "<prefix><name>": value, ...}``.
"""

from __future__ import annotations

import json
import os
from typing import Mapping


class MetricsLogger:
    def __init__(self, model_dir: str, use_tensorboard: bool = True):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(os.path.join(model_dir, "tb"))

    def log(self, step: int, scalars: Mapping[str, float],
            prefix: str = "") -> None:
        rec = {"step": int(step)}
        rec.update({prefix + k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(prefix + k, float(v), int(step))

    def close(self) -> None:
        self._f.close()
        if self.tb is not None:
            self.tb.close()
