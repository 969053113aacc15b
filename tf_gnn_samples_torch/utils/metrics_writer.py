"""Lightweight scalar-metrics writer (a copy of
tf_gnn_samples_tpu/utils/metrics_writer.py, which the port does not import).

Replaces the reference's TensorBoard FileWriter wiring
(models/sparse_graph_model.py:142-151, 321-326) with a dependency-free
JSONL stream (one record per (fold, step)); readable by pandas/jq and
cheap enough to leave always-on.
"""

import json
import os
import time


class MetricsWriter:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self._path = os.path.join(out_dir, "metrics.jsonl")

    def write(self, fold: str, step: int, scalars: dict) -> None:
        rec = {"fold": fold, "step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")
