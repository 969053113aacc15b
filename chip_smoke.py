#!/usr/bin/env python3
"""Drives the PyTorch port (tf_gnn_samples_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (no phase's failure is caught):
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from tf_gnn_samples_torch/csrc/ with nvcc;
 3. each kernel (K1 film_fwd, K2 film_bwd_dgb, K3 film_src_bwd) at the
    shapes of a real training batch of the tuned QM9 GNN-FiLM config,
    held against its plain PyTorch version on the card, and timed;
 4. the main path: `tf_gnn_samples_torch.train` trains GNN-FiLM on the
    bundled QM9 data at the tuned config for 2 epochs, then
    `tf_gnn_samples_torch.test` evaluates the written checkpoint; the
    kernel launch counters must show that every FiLM layer of every batch
    went through K1 (and K2, K3 in training);
 5. a reference check: loss and gradients of the full-width model on a
    small QM9 batch on the card (kernels) against the same model on the
    CPU (the kernels' plain versions).
The last lines are the card line, a `kernels` JSON line and the `ok` JSON
line. Exits non-zero, with no `ok` line, if there is no CUDA device or if
the package is not beside this script.

Usage: python3 chip_smoke.py
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "data", "qm9")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
TUNED_OVERRIDES = {"max_epochs": 2}  # everything else: QM9_GNN-FiLM.json
REPLACES = {  # TPU kernel each CUDA kernel replaces
    "film_fwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:333",
    "film_bwd_dgb": "tf_gnn_samples_tpu/ops/ranked_segment.py:433",
    "film_src_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:493",
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, torch, warmup=3, iters=20) -> float:
    """Median over `iters` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def first_batch(max_nodes: int, fold_name: str):
    """First batch of a QM9 fold (unshuffled) at `max_nodes` per batch."""
    from tf_gnn_samples_torch.tasks.base import DataFold
    from tf_gnn_samples_torch.tasks.qm9 import QM9_Task

    task = QM9_Task(QM9_Task.default_params())
    task.load_data(DATA)
    fold = DataFold[fold_name]
    return task, next(task.make_minibatch_iterator(
        task._loaded_data[fold], DataFold.VALIDATION, max_nodes))


def check_kernel(name, got, want, terms_abs, counts, torch):
    """|got - want| <= 2 * gamma_{n-1} * sum|t| + n * FLT_MIN per row: both
    are f32 sums of the same n bf16 terms, in two orders (the plain
    version's index_add_ and the kernel's stream order with atomics at
    chunk seams), and CUDA's float atomicAdd flushes subnormal results to
    zero. Rows of a single normal term must match exactly."""
    u = 2.0 ** -24
    flt_min = 2.0 ** -126
    n = counts.to(torch.float64)[:, None]
    gamma = (n - 1).clamp(min=0) * u / (1 - (n - 1).clamp(min=0) * u)
    bound = 2 * gamma * terms_abs.to(torch.float64) + n * flt_min
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    bad = int((err > bound).sum())
    max_err = float(err.max())
    print("  %s: max |kernel - plain| = %.3e, rows over the order bound: %d"
          % (name, max_err, bad))
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s disagrees with its plain version" % name)
    return max_err


def kernel_phase(torch, rs, dev):
    from tf_gnn_samples_torch.runtime.model import batch_to_device

    _, batch = first_batch(50000, "TRAIN")
    flat = batch_to_device(batch, dev).graph.flat
    e = int(flat.tgt_rank.numel())
    d = 128
    rpad = int(flat.fine_to_flat.numel())
    rsrc = int(flat.src_from_rank.numel())
    fine, src = flat.tgt_rank, flat.src_sorted_rank
    n_fine = int(fine[-1]) + 1
    n_src = int(src[-1]) + 1
    print("main-path shapes: E=%d D=%d RPAD=%d R_src=%d; fine groups %d, "
          "src groups %d" % (e, d, rpad, rsrc, n_fine, n_src))
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    act = "elu"
    dact = rs._ACTS[act][1]
    ones = torch.ones(e, device=dev)
    fine_counts = torch.zeros(rpad, device=dev).index_add_(0, fine, ones)
    src_counts = torch.zeros(rsrc, device=dev).index_add_(0, src, ones)

    def abs_sums(rows, ranks, terms):
        return torch.zeros((rows, terms.shape[1]), device=dev).index_add_(
            0, ranks, terms.abs())

    msgs, gb, gbg = randn(e, d), randn(rpad, 2 * d), randn(rpad, 3 * d)
    gcb, t = randn(e, 3 * d), randn(rsrc, d)
    # Per-edge bf16 terms of each kernel (for the order bound and for the
    # index_add_ yardstick, which sums precomputed terms only).
    g32 = gb.float().index_select(0, fine)
    k1_terms = rs._bf16_terms(rs._ACTS[act][0](g32[:, :d] * msgs.float()
                                               + g32[:, d:]))
    v = gbg.float().index_select(0, fine)
    dz = dact(v[:, :d] * msgs.float() + v[:, d:2 * d]) * v[:, 2 * d:]
    k2_terms = torch.cat([rs._bf16_terms(msgs.float() * dz),
                          rs._bf16_terms(dz)], 1)
    m = t.float().index_select(0, src)
    k3_terms = rs._bf16_terms(dact(gcb.float()[:, :d] * m + gcb.float()[:, d:2 * d])
                              * gcb.float()[:, 2 * d:])
    specs = [
        ("film_fwd",
         lambda: rs._film_fwd_impl(msgs, gb, fine, act=act),
         lambda: rs._film_fwd_plain(msgs, gb, fine, act),
         (rpad, fine, k1_terms, fine_counts),
         e * d * 2 + e * 4 + n_fine * 2 * d * 2 + rpad * d * 4,
         4 * e * d),
        ("film_bwd_dgb",
         lambda: rs._film_bwd_dgb_impl(msgs, gbg, fine, act=act),
         lambda: rs._film_bwd_dgb_plain(msgs, gbg, fine, act),
         (rpad, fine, k2_terms, fine_counts),
         e * d * 2 + e * 4 + n_fine * 3 * d * 2 + rpad * 2 * d * 4,
         7 * e * d),
        ("film_src_bwd",
         lambda: rs._film_src_bwd_impl(gcb, t, src, table_rows=rsrc, act=act),
         lambda: rs._film_src_bwd_plain(gcb, t, src, rsrc, act),
         (rsrc, src, k3_terms, src_counts),
         e * 3 * d * 2 + e * 4 + n_src * d * 2 + rsrc * d * 4,
         5 * e * d),
    ]
    results = []
    for name, kern, plain, (rows, ranks, terms, counts), nbytes, nops in specs:
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        max_err = check_kernel(name, got, want, abs_sums(rows, ranks, terms),
                               counts, torch)
        ms = cuda_ms(kern, torch)
        plain_ms = cuda_ms(plain, torch)
        yardstick_ms = cuda_ms(lambda: torch.zeros(
            (rows, terms.shape[1]), device=dev).index_add_(0, ranks, terms),
            torch)
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = nops / F32_FLOPS * 1e3
        bound_ms = max(bound_bytes_ms, bound_ops_ms)
        print("  %s: kernel %.4f ms, plain %.4f ms; bound %.4f ms (%d bytes "
              "at 3.35 TB/s; %d f32 ops at 67 TFLOP/s); no single PyTorch "
              "call computes this function, yardstick: index_add_ of the "
              "precomputed bf16 terms %.4f ms (leaves out the row gathers, "
              "the modulation and the activation)"
              % (name, ms, plain_ms, bound_ms, nbytes, nops, yardstick_ms))
        results.append({
            "name": name, "route": "cuda",
            "source": "tf_gnn_samples_torch/csrc/%s.cu" % name,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": None,
            "yardstick_ms": yardstick_ms,
            "yardstick": "torch.Tensor.index_add_ of the precomputed terms",
        })
    return results


def finite_log_values(path, pattern):
    """Float values of `pattern`'s group 1 in a run log; all finite."""
    with open(path) as f:
        vals = [float(m.group(1)) for m in map(pattern.match, f) if m]
    if not vals or not all(math.isfinite(v) for v in vals):
        raise AssertionError("%s: values %s in %s" % (pattern.pattern, vals,
                                                      path))
    return vals


def main_path_phase(rs):
    from tf_gnn_samples_torch import train as train_cli
    from tf_gnn_samples_torch import test as test_cli
    from tf_gnn_samples_torch.tasks.base import DataFold

    os.makedirs(OUT, exist_ok=True)
    args = train_cli.get_train_args([
        "GNN-FiLM", "QM9", "--data-path", DATA, "--result-dir", OUT,
        "--quiet", "--model-param-overrides", json.dumps(TUNED_OVERRIDES)])
    rs.reset_launches()
    t0 = time.time()
    (model,) = train_cli.run(args)
    launches = dict(rs.LAUNCHES)
    train_s = time.time() - t0
    layers = model.params["graph_num_layers"]
    n_train = model.batches_run[DataFold.TRAIN]
    n_valid = model.batches_run[DataFold.VALIDATION]
    want = {"film_fwd": layers * (n_train + n_valid),
            "film_bwd_dgb": layers * n_train, "film_src_bwd": layers * n_train}
    print("main path: %d train and %d valid batches in %.1f s; launches %s, "
          "expected %s" % (n_train, n_valid, train_s, launches, want))
    if launches != want:
        raise AssertionError("kernel launches %s != expected %s"
                             % (launches, want))
    for fold in ("Train", "Valid"):
        finite_log_values(model.log_file,
                          re.compile(r"^ %s: loss: (\S+) " % fold))

    rs.reset_launches()
    tmodel = test_cli.test(model.best_model_file,
                           os.path.join(DATA, "test.jsonl.gz"), OUT, quiet=True)
    n_test = tmodel.batches_run[DataFold.TEST]
    test_launches = dict(rs.LAUNCHES)
    want_test = {"film_fwd": layers * n_test, "film_bwd_dgb": 0,
                 "film_src_bwd": 0}
    print("test: %d batches; launches %s, expected %s"
          % (n_test, test_launches, want_test))
    if test_launches != want_test:
        raise AssertionError("test launches %s != expected %s"
                             % (test_launches, want_test))
    finite_log_values(tmodel.log_file, re.compile(r"^Loss (\S+) on "))
    return launches, step_times(model)


def step_times(model):
    """Host time to pack one training batch, and device time of one train
    and one eval step on it (median of CUDA-event timings)."""
    import torch

    from tf_gnn_samples_torch.runtime.model import batch_to_device
    from tf_gnn_samples_torch.tasks.base import DataFold

    batches = model.task.make_minibatch_iterator(
        model.task._loaded_data[DataFold.TRAIN], DataFold.TRAIN,
        model.params["max_nodes_in_batch"])
    t0 = time.perf_counter()
    batch = next(batches)
    pack_ms = (time.perf_counter() - t0) * 1e3
    dev_batch = batch_to_device(batch, model.device)
    times = {"layers": model.params["graph_num_layers"], "pack_ms": pack_ms,
             "train_step_ms": cuda_ms(lambda: model._train_step(dev_batch),
                                      torch, warmup=2, iters=5),
             "eval_step_ms": cuda_ms(lambda: model._eval_step(dev_batch),
                                     torch, warmup=2, iters=5)}
    print("one batch of %d graphs: host packing %.1f ms, train step %.2f ms, "
          "eval step %.2f ms (device)" % (batch.num_graphs, times["pack_ms"],
                                          times["train_step_ms"],
                                          times["eval_step_ms"]))
    return times


def reference_phase(torch):
    """Full-width model (tuned config) on a small QM9 batch: the card's
    kernels against the CPU's plain versions, same weights, no dropout."""
    import numpy as np

    from tf_gnn_samples_torch.runtime.model import (
        GNN_FiLM_Model, batch_to_device, params_to_jax)
    from tf_gnn_samples_torch.train import HYPERS_DIR

    with open(os.path.join(HYPERS_DIR, "QM9_GNN-FiLM.json")) as f:
        hypers = json.load(f)["model_params"]
    params = GNN_FiLM_Model.default_params()
    params.update(hypers)
    params["graph_layer_input_dropout_keep_prob"] = 1.0
    task, batch = first_batch(600, "VALIDATION")
    weights = params_to_jax(GNN_FiLM_Model(
        dict(params), task, "ref", OUT, device="cpu").model_params_tree)

    def loss_and_grads(dev, w):
        model = GNN_FiLM_Model(dict(params), task, "ref", OUT, device=dev)
        model.load_weights(w)
        loss, _ = model._forward(model.model_params_tree,
                                 batch_to_device(batch, model.device), None)
        grads = torch.autograd.grad(loss, model._leaves())
        return float(loss.detach()), [g.cpu().double() for g in grads]

    (lc, gc), (lp, gp) = loss_and_grads("cuda", weights), loss_and_grads(
        "cpu", weights)
    rel_loss = abs(lc - lp) / abs(lp)
    rel_grad = max(float((a - b).norm() / b.norm().clamp(min=1e-30))
                   for a, b in zip(gc, gp))
    # The bf16 message streams make the untrained 8-layer model sensitive
    # to last-bit differences, and the card's f32 matmuls and sums differ
    # from the CPU's in the last bits: measure how far weights scaled by
    # (1 + 1e-6 * noise) move the CPU loss. A wrong kernel moves the
    # card-CPU difference by O(1).
    rng = np.random.RandomState(1)
    nudged = {k: v * (1 + 1e-6 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in weights.items()}
    sensitivity = abs(loss_and_grads("cpu", nudged)[0] - lp) / abs(lp)
    print("reference: loss card %.7f cpu %.7f (rel %.2e); max per-tensor "
          "relative gradient difference %.2e; CPU loss moved %.2e by a 1e-6 "
          "relative weight nudge" % (lc, lp, rel_loss, rel_grad, sensitivity))
    if not (np.isfinite(lc) and rel_loss < 1e-2 and rel_grad < 5e-2):
        raise AssertionError("card and CPU disagree on the small batch")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tf_gnn_samples_torch")):
        print("chip_smoke: tf_gnn_samples_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tf_gnn_samples_torch.ops import cuda_build
    from tf_gnn_samples_torch.ops import ranked_segment as rs

    card = card_line()
    print(card)
    print("torch %s, CUDA %s, device %s" % (torch.__version__,
                                           torch.version.cuda,
                                           torch.cuda.get_device_name(0)))
    t0 = time.time()
    cuda_build.build_all()
    print("built %s in %.1f s" % (", ".join(cuda_build.KERNELS),
                                  time.time() - t0))
    for name, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))

    kernels = kernel_phase(torch, rs, torch.device("cuda"))
    launches, times = main_path_phase(rs)
    kernel_ms = times["layers"] * sum(k["ms"] for k in kernels)
    print("K1-K3 at %d launches each: %.2f ms, %.1f%% of the train step"
          % (times["layers"], kernel_ms,
             100 * kernel_ms / times["train_step_ms"]))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    reference_phase(torch)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
