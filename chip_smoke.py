#!/usr/bin/env python3
"""Drives the PyTorch port (tf_gnn_samples_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (no phase's failure is caught):
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from tf_gnn_samples_torch/csrc/ with nvcc;
 3. each of the nine kernels (K1 film_fwd, K2 film_bwd_dgb, K3
    film_src_bwd, K5a segsum, K5b expand, K6a segsum_t, K6b expand_t, K7a
    wseg_t, K7b wseg_t_bwd) at the shapes of the first training batch of
    the tuned QM9 configs (50,000-node packs; 8 attention heads), held
    against its plain PyTorch version on the card, and timed beside its
    bound and, where one PyTorch call computes the same function, that
    call; K6a and K6b are also held against their plain versions on the
    second table each meets on the RGAT path;
 4. the main paths: `tf_gnn_samples_torch.train` trains GNN-FiLM, RGCN,
    GGNN and RGAT on the bundled QM9 data at their tuned configs for 2
    epochs each, then `tf_gnn_samples_torch.test` evaluates each written
    checkpoint; the kernel launch counters, set to 0 before each run and
    read after it, must show that every layer of every batch went through
    its kernels (K1-K3 for GNN-FiLM; K5a forward and K5b backward for
    RGCN and GGNN; K6a, K6b, K7a, K7b and, in the message gather's
    backward, K5a for RGAT) and through no other;
 5. a reference check per model: loss and gradients of the full-width
    model on a small QM9 batch on the card (kernels) against the same
    model on the CPU (the kernels' plain versions).
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
TUNED_OVERRIDES = {"max_epochs": 2}  # everything else: QM9_<model>.json
MODELS = ("GNN-FiLM", "RGCN", "GGNN", "RGAT")
REPLACES = {  # TPU kernel each CUDA kernel replaces
    "film_fwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:333",
    "film_bwd_dgb": "tf_gnn_samples_tpu/ops/ranked_segment.py:433",
    "film_src_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:493",
    "segsum": "tf_gnn_samples_tpu/ops/ranked_segment.py:238",
    "expand": "tf_gnn_samples_tpu/ops/ranked_segment.py:259",
    "segsum_t": "tf_gnn_samples_tpu/ops/ranked_segment.py:1280",
    "expand_t": "tf_gnn_samples_tpu/ops/ranked_segment.py:1299",
    "wseg_t": "tf_gnn_samples_tpu/ops/ranked_segment.py:1314",
    "wseg_t_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:1341",
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


def cuda_queued_ms(fn, torch, iters=20) -> float:
    """Device time of one call when the card never waits for the host: a
    spin kernel keeps the card busy while the host enqueues `iters` calls
    behind it, and CUDA events bracket those calls. `cuda_ms` times one
    call at a time on an idle card, so it also holds the tens of
    microseconds the host takes between the call's first and last launch;
    the difference of the two is that host share."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # torch.cuda._sleep is private to PyTorch and spins for a number of
    # clock cycles: 40 million are about 20 ms at a clock near 2 GHz. The
    # result does not depend on that time, only on its outlasting the
    # host's enqueueing of `iters` calls.
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    graph = batch_to_device(batch, dev).graph
    flat = graph.flat
    e = int(flat.tgt_rank.numel())
    d = 128
    rpad = int(flat.fine_to_flat.numel())
    rsrc = int(flat.src_from_rank.numel())
    rows = rs.rank_table_rows(graph.n_pad, 256)
    fine, src, rcv = flat.tgt_rank, flat.src_sorted_rank, flat.rcv_rank
    n_fine = int(fine[-1]) + 1
    n_src = int(src[-1]) + 1
    n_rcv = int(rcv[-1]) + 1
    print("main-path shapes: E=%d D=%d n_pad=%d RPAD=%d R_src=%d rows=%d; "
          "fine groups %d, src groups %d, receiver groups %d"
          % (e, d, graph.n_pad, rpad, rsrc, rows, n_fine, n_src, n_rcv))
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    act = "elu"
    dact = rs._ACTS[act][1]
    ones = torch.ones(e, device=dev)

    def counts(n, ranks):
        return torch.zeros(n, device=dev).index_add_(0, ranks, ones)

    def abs_sums(n, ranks, terms):
        return torch.zeros((n, terms.shape[1]), device=dev).index_add_(
            0, ranks, terms.abs())

    def order_check(name, n, ranks, terms):
        return lambda got, want: check_kernel(
            name, got, want, abs_sums(n, ranks, terms), counts(n, ranks),
            torch)

    def exact_check(name):
        def check(got, want):
            max_err = float((got - want).abs().max())
            print("  %s: max |kernel - plain| = %.3e (must be 0)"
                  % (name, max_err))
            if not torch.equal(got, want):
                raise AssertionError("%s disagrees with its plain version"
                                     % name)
            return max_err
        return check

    def index_add(n, ranks, terms):
        return lambda: torch.zeros((n, terms.shape[1]), device=dev).index_add_(
            0, ranks, terms)

    def wseg_bwd_check(got, want):
        """K7b: d_msgs must equal the plain version's; d_w_t is an f32 sum
        of D / K exact products in another order."""
        (dm, dw), (dm_want, dw_want) = got, want
        err_m = exact_check("wseg_t_bwd d_msgs")(dm.float(), dm_want.float())
        prods = (m7.float() * g7.float().index_select(0, rcv)).abs()
        sums = prods.reshape(e, heads, -1).sum(-1).t()
        err_w = check_kernel(
            "wseg_t_bwd d_w_t", dw.reshape(-1, 1), dw_want.reshape(-1, 1),
            sums.reshape(-1, 1),
            torch.full((e * heads,), float(d // heads), device=dev), torch)
        return max(err_m, err_w)

    msgs, gb, gbg = randn(e, d), randn(rpad, 2 * d), randn(rpad, 3 * d)
    gcb, t = randn(e, 3 * d), randn(rsrc, d)
    # Per-edge bf16 terms of each FiLM kernel (for the order bound and for
    # the index_add_ yardstick, which sums precomputed terms only).
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
    # K5 inputs: f32, as RGCN/GGNN messages (and table cotangents) are.
    m5 = torch.randn((e, d), generator=gen, device=dev)
    table5 = torch.randn((rows, d), generator=gen, device=dev)
    # K6 / K7 inputs at the RGAT config's 8 heads: head-major f32 streams
    # and tables, a bf16 message stream, attention-like weights in [0, 1)
    # and the bf16 table cotangent.
    heads = 8
    m_t = torch.randn((heads, e), generator=gen, device=dev)
    table_t = torch.randn((heads, rpad), generator=gen, device=dev)
    m7, g7 = randn(e, d), randn(rows, d)
    w_t = torch.rand((heads, e), generator=gen, device=dev)
    k7_terms = rs._bf16_terms(m7.float() * rs._head_replicate(w_t, d))
    film_yardstick = ("torch.Tensor.index_add_ of the precomputed terms "
                      "(leaves out the row gathers, the modulation and the "
                      "activation)")
    specs = [
        dict(name="film_fwd",
             kern=lambda: rs._film_fwd_impl(msgs, gb, fine, act=act),
             plain=lambda: rs._film_fwd_plain(msgs, gb, fine, act),
             check=order_check("film_fwd", rpad, fine, k1_terms),
             nbytes=e * d * 2 + e * 4 + n_fine * 2 * d * 2 + rpad * d * 4,
             nops=4 * e * d,
             yardstick=(film_yardstick, index_add(rpad, fine, k1_terms))),
        dict(name="film_bwd_dgb",
             kern=lambda: rs._film_bwd_dgb_impl(msgs, gbg, fine, act=act),
             plain=lambda: rs._film_bwd_dgb_plain(msgs, gbg, fine, act),
             check=order_check("film_bwd_dgb", rpad, fine, k2_terms),
             nbytes=e * d * 2 + e * 4 + n_fine * 3 * d * 2 + rpad * 2 * d * 4,
             nops=7 * e * d,
             yardstick=(film_yardstick, index_add(rpad, fine, k2_terms))),
        dict(name="film_src_bwd",
             kern=lambda: rs._film_src_bwd_impl(gcb, t, src, table_rows=rsrc,
                                                act=act),
             plain=lambda: rs._film_src_bwd_plain(gcb, t, src, rsrc, act),
             check=order_check("film_src_bwd", rsrc, src, k3_terms),
             nbytes=e * 3 * d * 2 + e * 4 + n_src * d * 2 + rsrc * d * 4,
             nops=5 * e * d,
             yardstick=(film_yardstick, index_add(rsrc, src, k3_terms))),
        # K5a reads the f32 stream and the ranks and writes the table; one
        # add per element. Library: index_add_ of the unrounded stream.
        dict(name="segsum",
             kern=lambda: rs._segsum_table_impl(m5, rcv, table_rows=rows),
             plain=lambda: rs._segsum_plain(m5, rcv, rows),
             check=order_check("segsum", rows, rcv, rs._bf16_terms(m5)),
             nbytes=e * d * 4 + e * 4 + rows * d * 4, nops=e * d,
             library=("torch.Tensor.index_add_",
                      index_add(rows, rcv, m5))),
        # K5b reads the used table rows and the ranks and writes [E, D] f32;
        # one rounding per element. Library: index_select, unrounded.
        dict(name="expand",
             kern=lambda: rs._expand_impl(table5, rcv),
             plain=lambda: rs._expand_plain(table5, rcv),
             check=exact_check("expand"),
             nbytes=n_rcv * d * 4 + e * 4 + e * d * 4, nops=e * d,
             library=("torch.Tensor.index_select",
                      lambda: table5.index_select(0, rcv))),
        # K6a (the softmax denominator over receiver ranks) reads the f32
        # [K, E] stream and the ranks and writes the [K, rows] table; one
        # add per element. Library: index_add_ along the edge axis.
        dict(name="segsum_t",
             kern=lambda: rs._segsum_t_impl(m_t, rcv, table_rows=rows),
             plain=lambda: rs._segsum_t_plain(m_t, rcv, rows),
             check=lambda got, want: order_check(
                 "segsum_t", rows, rcv, rs._bf16_terms(m_t).t())(
                     got.t(), want.t()),
             nbytes=heads * e * 4 + e * 4 + heads * rows * 4, nops=heads * e,
             library=("torch.Tensor.index_add_",
                      lambda: torch.zeros((heads, rows), device=dev).index_add_(
                          1, rcv, m_t))),
        # K6b (the target logits over fine ranks, the larger of its two
        # tables on the main path) reads the used table entries and the
        # ranks and writes [K, E] f32. Library: index_select.
        dict(name="expand_t",
             kern=lambda: rs._expand_t_impl(table_t, fine),
             plain=lambda: rs._expand_t_plain(table_t, fine),
             check=exact_check("expand_t"),
             nbytes=n_fine * heads * 4 + e * 4 + heads * e * 4,
             nops=heads * e,
             library=("torch.Tensor.index_select",
                      lambda: table_t.index_select(1, fine))),
        # K7a reads the bf16 stream, the [K, E] weights and the ranks and
        # writes the table; a multiply and an add per element.
        dict(name="wseg_t",
             kern=lambda: rs._wseg_t_impl(m7, w_t, rcv, table_rows=rows,
                                          num_heads=heads),
             plain=lambda: rs._wseg_t_plain(m7, w_t, rcv, rows),
             check=order_check("wseg_t", rows, rcv, k7_terms),
             nbytes=e * d * 2 + heads * e * 4 + e * 4 + rows * d * 4,
             nops=2 * e * d,
             yardstick=(film_yardstick, index_add(rows, rcv, k7_terms))),
        # K7b reads the stream, the weights, the ranks and the used rows of
        # the bf16 cotangent table and writes d_msgs (bf16) and d_w_t;
        # two multiplies and an add per element.
        dict(name="wseg_t_bwd",
             kern=lambda: rs._wseg_t_bwd_impl(m7, w_t, g7, rcv,
                                              num_heads=heads),
             plain=lambda: rs._wseg_t_bwd_plain(m7, w_t, g7, rcv),
             check=wseg_bwd_check,
             nbytes=(2 * e * d * 2 + 2 * heads * e * 4 + e * 4
                     + n_rcv * d * 2),
             nops=3 * e * d),
    ]
    # The RGAT path gives each K6 kernel two tables: K6a also sums the
    # target logits' cotangent over the fine ranks (shorter runs, more
    # seams per thread), K6b also expands the denominator over the
    # receiver ranks. These are checked only; the specs above are timed.
    table_rcv = torch.randn((heads, rows), generator=gen, device=dev)
    also = {
        "segsum_t": lambda: order_check(
            "segsum_t (fine ranks, %d rows)" % rpad, rpad, fine,
            rs._bf16_terms(m_t).t())(
                rs._segsum_t_impl(m_t, fine, table_rows=rpad).t(),
                rs._segsum_t_plain(m_t, fine, rpad).t()),
        "expand_t": lambda: exact_check(
            "expand_t (receiver ranks, %d rows)" % rows)(
                rs._expand_t_impl(table_rcv, rcv),
                rs._expand_t_plain(table_rcv, rcv)),
    }
    results = []
    for spec in specs:
        name = spec["name"]
        got = spec["kern"]()
        torch.cuda.synchronize()
        max_err = spec["check"](got, spec["plain"]())
        if name in also:
            max_err = max(max_err, also[name]())
        ms = cuda_ms(spec["kern"], torch)
        plain_ms = cuda_ms(spec["plain"], torch)
        bound_bytes_ms = spec["nbytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = spec["nops"] / F32_FLOPS * 1e3
        bound_ms = max(bound_bytes_ms, bound_ops_ms)
        row = {
            "name": name, "route": "cuda",
            "source": "tf_gnn_samples_torch/csrc/%s.cu" % name,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": None,
            "queued_ms": cuda_queued_ms(spec["kern"], torch),
        }
        if "library" in spec:
            what, fn = spec["library"]
            row["library_ms"] = cuda_ms(fn, torch)
            other = "library (%s) %.4f ms" % (what, row["library_ms"])
        elif "yardstick" in spec:
            what, fn = spec["yardstick"]
            row["yardstick_ms"] = cuda_ms(fn, torch)
            row["yardstick"] = what
            other = ("no single PyTorch call computes this function; "
                     "yardstick: %s %.4f ms" % (what, row["yardstick_ms"]))
        else:
            other = "no single PyTorch call computes this function"
        print("  %s: kernel %.4f ms (%.4f ms queued behind a busy card), "
              "plain %.4f ms; bound %.4f ms (%d bytes at 3.35 TB/s; %d f32 "
              "ops at 67 TFLOP/s); %s"
              % (name, ms, row["queued_ms"], plain_ms, bound_ms,
                 spec["nbytes"], spec["nops"], other))
        results.append(row)
    return results


def finite_log_values(path, pattern):
    """Float values of `pattern`'s group 1 in a run log; all finite."""
    with open(path) as f:
        vals = [float(m.group(1)) for m in map(pattern.match, f) if m]
    if not vals or not all(math.isfinite(v) for v in vals):
        raise AssertionError("%s: values %s in %s" % (pattern.pattern, vals,
                                                      path))
    return vals


def expected_launches(model_name, layers, n_fwd, n_bwd):
    """Kernel launches of `n_fwd` forward passes, `n_bwd` of them with a
    backward pass, through `layers` message-passing layers; no kernel of
    another family runs. GNN-FiLM runs K1 forward and K2 + K3 backward;
    RGCN and GGNN K5a forward and K5b backward. An RGAT layer runs, forward,
    K6b for the target logits, K6a and K6b for the softmax denominator and
    K7a; backward, K7b, the VJPs of those three K6 launches (K6a twice,
    K6b once) and K5a in the message gather's backward."""
    want = {k: 0 for k in REPLACES}
    if model_name == "GNN-FiLM":
        want.update(film_fwd=layers * n_fwd, film_bwd_dgb=layers * n_bwd,
                    film_src_bwd=layers * n_bwd)
    elif model_name == "RGAT":
        want.update(expand_t=layers * (2 * n_fwd + n_bwd),
                    segsum_t=layers * (n_fwd + 2 * n_bwd),
                    wseg_t=layers * n_fwd, wseg_t_bwd=layers * n_bwd,
                    segsum=layers * n_bwd)
    else:
        want.update(segsum=layers * n_fwd, expand=layers * n_bwd)
    return want


def main_path_phase(rs, model_name):
    """Train `model_name` at its tuned QM9 config for 2 epochs, test its
    checkpoint; returns the training run's launches, and the step times
    with the launches counted in one train step."""
    from tf_gnn_samples_torch import train as train_cli
    from tf_gnn_samples_torch import test as test_cli
    from tf_gnn_samples_torch.tasks.base import DataFold

    out = os.path.join(OUT, model_name)
    os.makedirs(out, exist_ok=True)
    args = train_cli.get_train_args([
        model_name, "QM9", "--data-path", DATA, "--result-dir", out,
        "--quiet", "--model-param-overrides", json.dumps(TUNED_OVERRIDES)])
    rs.reset_launches()
    t0 = time.time()
    (model,) = train_cli.run(args)
    launches = dict(rs.LAUNCHES)
    train_s = time.time() - t0
    layers = (model.params["graph_num_layers"]
              * model.params["graph_num_timesteps_per_layer"])
    n_train = model.batches_run[DataFold.TRAIN]
    n_valid = model.batches_run[DataFold.VALIDATION]
    want = expected_launches(model_name, layers, n_train + n_valid, n_train)
    print("%s main path: %d train and %d valid batches in %.1f s; launches "
          "%s, expected %s" % (model_name, n_train, n_valid, train_s,
                               launches, want))
    if launches != want:
        raise AssertionError("kernel launches %s != expected %s"
                             % (launches, want))
    for fold in ("Train", "Valid"):
        finite_log_values(model.log_file,
                          re.compile(r"^ %s: loss: (\S+) " % fold))

    rs.reset_launches()
    tmodel = test_cli.test(model.best_model_file,
                           os.path.join(DATA, "test.jsonl.gz"), out, quiet=True)
    n_test = tmodel.batches_run[DataFold.TEST]
    test_launches = dict(rs.LAUNCHES)
    want_test = expected_launches(model_name, layers, n_test, 0)
    print("%s test: %d batches; launches %s, expected %s"
          % (model_name, n_test, test_launches, want_test))
    if test_launches != want_test:
        raise AssertionError("test launches %s != expected %s"
                             % (test_launches, want_test))
    finite_log_values(tmodel.log_file, re.compile(r"^Loss (\S+) on "))
    return launches, step_times(rs, model)


def host_enqueue_ms(fn, torch, iters=5) -> float:
    """Median host time until `fn` returns on an idle card, without
    waiting for the card: what the host needs to enqueue the call's work.
    Where it is close to the call's device time, the host and not the card
    sets that time."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def step_times(rs, model):
    """Host time to pack one training batch, device time of one train and
    one eval step on it (median of CUDA-event timings), the host's time
    to enqueue the train step, and the launch counters of one train
    step."""
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
    rs.reset_launches()
    model._train_step(dev_batch)
    step_launches = {k: n for k, n in rs.LAUNCHES.items() if n}
    times = {"pack_ms": pack_ms,
             "train_step_ms": cuda_ms(lambda: model._train_step(dev_batch),
                                      torch, warmup=2, iters=5),
             "eval_step_ms": cuda_ms(lambda: model._eval_step(dev_batch),
                                     torch, warmup=2, iters=5),
             "train_step_host_ms": host_enqueue_ms(
                 lambda: model._train_step(dev_batch), torch)}
    print("%s: one batch of %d graphs: host packing %.1f ms, train step "
          "%.2f ms, eval step %.2f ms (device); the host enqueues the train "
          "step in %.2f ms"
          % (model.name(model.params), batch.num_graphs, times["pack_ms"],
             times["train_step_ms"], times["eval_step_ms"],
             times["train_step_host_ms"]))
    return times, step_launches


def reference_phase(torch, rs, model_name, card="cuda"):
    """Full-width model (tuned config) on a small QM9 batch: the card's
    kernels against the CPU's plain versions, same weights, no dropout.
    At 600 nodes RGCN and GGNN would take the dense strategy ("auto"), so
    they are set to the ranked one ("pallas") and must launch K5; RGAT
    takes its streamed branch under either."""
    import numpy as np

    from tf_gnn_samples_torch.runtime.model import batch_to_device, params_to_jax
    from tf_gnn_samples_torch.train import HYPERS_DIR
    from tf_gnn_samples_torch.utils.registry import name_to_model_class

    cls, _ = name_to_model_class(model_name)
    with open(os.path.join(HYPERS_DIR, "QM9_%s.json" % model_name)) as f:
        hypers = json.load(f)["model_params"]
    params = cls.default_params()
    params.update(hypers)
    params["graph_layer_input_dropout_keep_prob"] = 1.0
    if model_name != "GNN-FiLM":
        params["aggregation_strategy"] = "pallas"
    task, batch = first_batch(600, "VALIDATION")
    out = os.path.join(OUT, model_name)
    weights = params_to_jax(cls(dict(params), task, "ref", out,
                                device="cpu").model_params_tree)

    def loss_and_grads(dev, w):
        model = cls(dict(params), task, "ref", out, device=dev)
        model.load_weights(w)
        loss, _ = model._forward(model.model_params_tree,
                                 batch_to_device(batch, model.device), None)
        grads = torch.autograd.grad(loss, model._leaves())
        return float(loss.detach()), [g.cpu().double() for g in grads]

    rs.reset_launches()
    lc, gc = loss_and_grads(card, weights)
    launches = dict(rs.LAUNCHES)
    used = [k for k, n in expected_launches(model_name, 1, 1, 1).items() if n]
    if not all(launches[k] > 0 for k in used):
        raise AssertionError("%s reference: launches %s" % (model_name,
                                                            launches))
    lp, gp = loss_and_grads("cpu", weights)
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
    print("%s reference: loss card %.7f cpu %.7f (rel %.2e); max per-tensor "
          "relative gradient difference %.2e; CPU loss moved %.2e by a 1e-6 "
          "relative weight nudge; card launches %s"
          % (model_name, lc, lp, rel_loss, rel_grad, sensitivity, launches))
    if not (np.isfinite(lc) and rel_loss < 1e-2 and rel_grad < 5e-2):
        raise AssertionError("%s: card and CPU disagree on the small batch"
                             % model_name)


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
    kernel_ms = {k["name"]: k["ms"] for k in kernels}
    queued_ms = {k["name"]: k["queued_ms"] for k in kernels}
    total = {k["name"]: 0 for k in kernels}
    for model_name in MODELS:
        launches, (times, per_step) = main_path_phase(rs, model_name)
        for name, n in launches.items():
            total[name] += n
        share = sum(n * kernel_ms[k] for k, n in per_step.items())
        queued = sum(n * queued_ms[k] for k, n in per_step.items())
        print("%s: kernel launches counted in one train step %s: %.2f ms at "
              "the single-call times above (%.2f ms at the queued times), "
              "%.1f%% of the train step"
              % (model_name, per_step, share, queued,
                 100 * share / times["train_step_ms"]))
    for k in kernels:
        k["launches"] = total[k["name"]]
    for model_name in MODELS:
        reference_phase(torch, rs, model_name)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
