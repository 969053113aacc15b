#!/usr/bin/env python
"""Standalone CLI: re-shard raw VarMisuse .json.gz files into small shuffled
chunk files for streaming training (counterpart of
tf_gnn_samples_tpu/utils/varmisuse_data_splitter.py).

Capability-parity with the reference's utils/varmisuse_data_splitter.py
(·:1-97): spawned workers read the raw shards, the samples are shuffled in
fixed-size windows and written as chunk_<window>-<chunk>.jsonl.gz files
of --chunk-size samples. The shards are taken in file order (the JAX
package's in completion order), so for the same input and numpy seed the
chunks hold the same samples in the same order however many workers read.
Numpy only: it imports no torch.

Usage:
    python -m tf_gnn_samples_torch.utils.varmisuse_data_splitter [options] RAW_DATA_DIR OUT_DIR
"""

import argparse
import gzip
import json
import multiprocessing
import os
from multiprocessing import cpu_count
from typing import Any, List

import numpy as np


def _read_raw_shard(path: str) -> List[Any]:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        if ".jsonl" in path:
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def _write_data(out_dir: str, window_idx: int, chunk_size: int,
                data_window: List[Any]) -> None:
    np.random.shuffle(data_window)
    for chunk_idx in range(0, max(len(data_window), 1), chunk_size):
        chunk = data_window[chunk_idx:chunk_idx + chunk_size]
        if not chunk:
            continue
        out_file = os.path.join(
            out_dir, "chunk_%i-%i.jsonl.gz" % (window_idx,
                                               chunk_idx // chunk_size))
        with gzip.open(out_file, "wt", encoding="utf-8") as f:
            for sample in chunk:
                f.write(json.dumps(sample) + "\n")


def run(args):
    os.makedirs(args.OUT_DIR, exist_ok=True)
    files_to_load = sorted(
        os.path.join(args.RAW_DATA_DIR, f)
        for f in os.listdir(args.RAW_DATA_DIR)
        if f.endswith(".gz")
    )
    num_workers = int(args.num_workers or cpu_count())
    chunk_size = int(args.chunk_size)
    window_size = int(args.window_size)

    ctx = multiprocessing.get_context("spawn")
    data_window: List[Any] = []
    window_idx = 0
    with ctx.Pool(num_workers) as pool:
        for samples in pool.imap(_read_raw_shard, files_to_load):
            data_window.extend(samples)
            while len(data_window) >= window_size:
                _write_data(args.OUT_DIR, window_idx, chunk_size,
                            data_window[:window_size])
                data_window = data_window[window_size:]
                window_idx += 1
    if data_window:
        _write_data(args.OUT_DIR, window_idx, chunk_size, data_window)


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("RAW_DATA_DIR")
    parser.add_argument("OUT_DIR")
    parser.add_argument("--chunk-size", default=100)
    parser.add_argument("--num-workers", default=None)
    parser.add_argument("--window-size", default=5000)
    return parser.parse_args(argv)


if __name__ == "__main__":
    run(get_args())
