#!/usr/bin/env python3
"""Drives the PyTorch port (tf_gnn_samples_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (no phase's failure is caught):
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from tf_gnn_samples_torch/csrc/ with nvcc;
 3. each of the nineteen kernels (K1 film_fwd, K2 film_bwd_dgb, K3
    film_src_bwd, K4 film_bwd, K5a segsum, K5b expand, K6a segsum_t, K6b
    expand_t, K7a wseg_t, K7b wseg_t_bwd, K8 wseg_t_dw, K9 rgat_src_bwd,
    K10a typed_dense_agg, K10b typed_dense_agg_bwd, K11a expand_add_act,
    K11b expand_add_act_bwd, K12a act_agg, K12b act_agg_bwd, K14
    emlp1_src_bwd)
    at the shapes of the first training batch of the tuned QM9 configs
    (50,000-node packs; 8 attention heads), held against its plain
    PyTorch version on the card, and timed beside its bound and, where
    one PyTorch call computes the same function, that call; K6a and K6b
    are also held against their plain versions on the second table each
    meets on the RGAT path, K12a and K12b on every edge type's slice of
    the type-major stream (the shapes GNN-Edge-MLP1 gives them; they are
    timed on the largest) and over the whole stream, and K3, K9 and K14
    on the DILUTED src stream of a numpy-made graph of PPI-like degree
    (QM9's streams are undiluted);
 4. the main paths: `tf_gnn_samples_torch.train` trains GNN-FiLM (with
    and without normalised messages), RGCN, GGNN, RGAT (on its fused and
    on its streamed branch, one of the two through a forced gate), RGIN
    (ranked branch: K5a both ways), GNN-Edge-MLP1 (type-major branch; its
    `fused_src1` form with K14, with ENABLE_EMLP1_SRC_PASS set; and its
    `fused1` branch with K10, through a forced gate that hides the
    type-major view), GNN-Edge-MLP1 without the target state (ranked
    branch) and GNN-Edge-MLP0 (FiLM kernels) on the bundled QM9 data at
    their tuned configs for 2 epochs each, then `tf_gnn_samples_torch.test`
    evaluates each written checkpoint; the kernel launch counters, set to
    0 before each run and read after it, must show that every layer of
    every batch went through its kernels (`expected_launches`) and through
    no other;
 5. a reference check per path: loss and gradients of the full-width
    model on a small QM9 batch on the card (kernels) against the same
    model on the CPU (the kernels' plain versions), with the same gates
    forced.
Usage: python3 chip_smoke.py
"""

import collections
import contextlib
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
BF16_TENSOR_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TUNED_OVERRIDES = {"max_epochs": 2}  # everything else: QM9_<model>.json
# A main path: a model at its tuned config, the overrides that select the
# path, for RGAT the branch it is, and the gate a path forces (`gate`,
# see forced_gate). The branch RGAT's gate picks at the tuned batch trains
# with the gate as it is (its launches tell which branch ran), the other
# one through a forced gate. The card-against-CPU reference runs on a
# small batch, where the gate picks otherwise, and forces both.
Path = collections.namedtuple("Path", "label model overrides rgat_fused gate",
                              defaults=(None, None))
PATHS = (
    Path("GNN-FiLM", "GNN-FiLM", {}),
    Path("GNN-FiLM-normalised", "GNN-FiLM",
         {"normalize_messages_by_num_incoming": True}),
    Path("RGCN", "RGCN", {}),
    Path("GGNN", "GGNN", {}),
    Path("RGAT-fused", "RGAT", {}, True),
    Path("RGAT-streamed", "RGAT", {}, False),
    Path("GNN-Edge-MLP1", "GNN-Edge-MLP1", {}),
    Path("GNN-Edge-MLP0", "GNN-Edge-MLP0", {}),
    Path("RGIN", "RGIN", {}),
    Path("GNN-Edge-MLP1-fused1", "GNN-Edge-MLP1", {}, gate="no_type_major"),
    Path("GNN-Edge-MLP1-src", "GNN-Edge-MLP1", {}, gate="emlp1_src"),
    Path("GNN-Edge-MLP-ranked", "GNN-Edge-MLP1",
         {"use_target_state_as_input": False}),
)
# QM9 has five edge types: the self loops (type 0), which GNN-Edge-MLP1
# combines node-side, and four that stream through K12.
QM9_TM_SELF = (True, False, False, False, False)
QM9_STREAMED_TYPES = QM9_TM_SELF.count(False)
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
    "film_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:526",
    "wseg_t_dw": "tf_gnn_samples_tpu/ops/ranked_segment.py:1933",
    "rgat_src_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:1985",
    "expand_add_act": "tf_gnn_samples_tpu/ops/ranked_segment.py:700",
    "expand_add_act_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:717",
    "act_agg": "tf_gnn_samples_tpu/ops/ranked_segment.py:855",
    "act_agg_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:875",
    "typed_dense_agg": "tf_gnn_samples_tpu/ops/ranked_segment.py:1084",
    "typed_dense_agg_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:1108",
    "emlp1_src_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:2305",
}


@contextlib.contextmanager
def patched(obj, name, value):
    """obj.name = value for the block."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def rgat_branch(rs, fused):
    """Force RGAT's gate (ops/ranked_segment.py rgat_fused_supported) to
    `fused` for the block, as the tests do; None leaves it as it is."""
    if fused is None:
        return contextlib.nullcontext()
    return patched(rs, "rgat_fused_supported", lambda *args, **kwargs: fused)


def forced_gate(rs, layers, gate):
    """Force a GNN-Edge-MLP gate for the block: "no_type_major" hides the
    type-major view from the layer's branch choice (nn/layers.py
    tm_available), so the tuned GNN-Edge-MLP1 takes its `fused1` branch
    (K10); "emlp1_src" sets ops/ranked_segment.py ENABLE_EMLP1_SRC_PASS,
    so its type-major branch takes the `fused_src1` form (K14). None
    leaves the gates as they are."""
    if gate is None:
        return contextlib.nullcontext()
    if gate == "no_type_major":
        return patched(layers, "tm_available", lambda graph: False)
    if gate == "emlp1_src":
        return patched(rs, "ENABLE_EMLP1_SRC_PASS", True)
    raise ValueError("unknown gate %r" % gate)


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


def device_busy_ms(fn, torch, calls=3) -> float:
    """Device time per call of `fn` that the card spends in kernels and
    copies (torch.profiler: the self device time of every device event of
    `calls` calls, over `calls`). The rest of a step's device-timeline
    time (`cuda_ms`) the card waits for the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return busy_us / 1e3 / calls


def first_batch(max_nodes: int, fold_name: str):
    """First batch of a QM9 fold (unshuffled) at `max_nodes` per batch."""
    from tf_gnn_samples_torch.tasks.base import DataFold
    from tf_gnn_samples_torch.tasks.qm9 import QM9_Task

    task = QM9_Task(QM9_Task.default_params())
    task.load_data(DATA)
    fold = DataFold[fold_name]
    return task, next(task.make_minibatch_iterator(
        task._loaded_data[fold], DataFold.VALIDATION, max_nodes))


def check_kernel(name, got, want, terms_abs, counts, torch, term_ulps=0,
                 slack=0.0):
    """|got - want| <= 2 * gamma_{n-1} * sum|t| + n * FLT_MIN per row: both
    are f32 sums of the same n bf16 terms, in two orders (the plain
    version's index_add_ and the kernel's stream order with atomics at
    chunk seams), and CUDA's float atomicAdd flushes subnormal results to
    zero. Rows of a single normal term must match exactly. `term_ulps`
    allows each term to differ by that many bf16 ulps (at most 2^-7 of
    itself each) between the two, for a kernel whose terms go through exp
    and a division before they are rounded: the kernel's expf and
    PyTorch's exp may differ in the last f32 bit, which can carry a term to
    the neighbouring bf16 number. `slack` is a further absolute allowance
    per entry (see rgat_src_bwd_bounds)."""
    u = 2.0 ** -24
    flt_min = 2.0 ** -126
    n = counts.to(torch.float64)[:, None]
    gamma = (n - 1).clamp(min=0) * u / (1 - (n - 1).clamp(min=0) * u)
    bound = ((2 * gamma + term_ulps * 2.0 ** -7) * terms_abs.to(torch.float64)
             + n * flt_min + slack)
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    bad = int((err > bound).sum())
    max_err = float(err.max())
    print("  %s: max |kernel - plain| = %.3e, rows over the order bound: %d"
          % (name, max_err, bad))
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s disagrees with its plain version" % name)
    return max_err


def per_row(torch, rows, ranks, x):
    """f64 [rows, D] sums of the per-edge rows `x` by rank."""
    return torch.zeros((rows, x.shape[1]), device=x.device,
                       dtype=torch.float64).index_add_(0, ranks, x.double())


def rgat_src_bwd_bounds(torch, rs, gcb, t_ext, ranks, rows, heads):
    """(sum of |term|, number of terms, slack) per entry of K9's output,
    for check_kernel. The terms are K9's plain version with every edge a
    rank of its own. The slack covers what one bf16 ulp per term does not:
    the logit cotangent attn * (draw - cor) cancels, and draw, an f32 sum
    of D / K exact products, is taken in another order by the kernel, so
    that term may move by attn * 2 gamma_{D/K} * sum|m * dagg| whatever
    its own size."""
    e = ranks.shape[0]
    dim = t_ext.shape[1] - heads
    t_rows = t_ext.index_select(0, ranks)
    terms = rs._rgat_src_bwd_plain(
        gcb, t_rows, torch.arange(e, device=gcb.device), e, heads, 50.0)
    g = gcb.float()
    pre = t_rows[:, dim:].float() + g[:, dim:dim + heads]
    logit = torch.where(pre > 0, pre, 0.2 * pre)
    attn = torch.exp(logit.clamp(-50.0, 50.0)) / (
        g[:, dim + heads:dim + 2 * heads] + 1e-7)
    draw_abs = (t_rows[:, :dim].float() * g[:, :dim]).abs().reshape(
        e, heads, -1).sum(-1)
    per_edge = torch.cat(
        [torch.zeros((e, dim), device=gcb.device),
         attn * draw_abs * (2 * (dim // heads) * 2.0 ** -24)], 1)
    counts = torch.zeros(rows, device=gcb.device).index_add_(
        0, ranks, torch.ones(e, device=gcb.device))
    return (per_row(torch, rows, ranks, terms.abs()), counts,
            per_row(torch, rows, ranks, per_edge))


def kernel_order_products(torch, a, w, types):
    """y[e] = a_e @ w[type_e], f32 [E, D_out], summed as K10 and K14 sum
    their typed products: per output entry one f32 add per term, in index
    order over the inner axis, each term the exact f32 product of two bf16
    numbers (the kernels build with -fmad=false), so this equals the
    kernels' sums bit for bit. An edge whose type is not in [0, L) gets 0."""
    y = torch.zeros((a.shape[0], w.shape[2]), dtype=torch.float32,
                    device=a.device)
    for l in range(w.shape[0]):
        sel = (types == l).nonzero(as_tuple=True)[0]
        if not sel.numel():
            continue
        al, wl = a.index_select(0, sel).float(), w[l].float()
        acc = torch.zeros((sel.numel(), w.shape[2]), dtype=torch.float32,
                          device=a.device)
        for k in range(w.shape[1]):
            acc = acc + al[:, k:k + 1] * wl[k]
        y.index_copy_(0, sel, acc)
    return y


# The checks of K10 and K14 compute each edge's terms as the kernel does:
# its typed products in its own order (kernel_order_products), and its
# activations, their derivatives and the bf16 roundings by the plain
# version's f32 expressions, which the kernels evaluate in the same
# operation order (film_common.cuh; K11a and K12b are held to them
# exactly). The plain version sums the products in another order
# (torch.matmul), which can round a y, and so a dz or da, or a dx to the
# neighbouring bf16 number. So a kernel's output may differ from the plain
# version's by no more than the same math in the kernel's order does:
# entry by entry that is 0 for all but the few entries the two orders
# round apart, and a dropped, doubled or misplaced term of any product
# shows at once (tests/test_torch_chip_checks.py plants such faults). A
# kernel that changes its order of the products changes
# kernel_order_products with it.


def typed_dense_agg_bounds(torch, rs, x, w, types, ranks, rows, act):
    """(sum of |term|, number of terms, slack) per entry of K10a's output,
    for check_kernel (term_ulps=0): the terms bf16(act(y_e)) with y_e
    summed in the kernel's order and in the plain version's, and as slack
    the per-entry sum of their differences."""
    fn = rs._ACTS[act][0]
    t_ko = rs._bf16_terms(fn(kernel_order_products(torch, x, w, types)))
    t_p = rs._bf16_terms(fn(rs._typed_products(x, w, types)))
    counts = torch.zeros(rows, device=x.device).index_add_(
        0, ranks, torch.ones(ranks.shape[0], device=x.device))
    return (per_row(torch, rows, ranks, torch.maximum(t_ko.abs(), t_p.abs())),
            counts, per_row(torch, rows, ranks, (t_ko - t_p).abs()))


def typed_dense_agg_bwd_check(torch, rs, got, want, x, w, g16, types, ranks,
                              act):
    """K10b's (dx, dW) against the plain version's on the same inputs.
    dz = bf16(act'(y) * g16[rank]) and dx = bf16(dz @ W^T) in the kernel's
    order of both products: |dx - dx_plain| may be no larger than that
    kernel-order dx's distance from dx_plain, entry by entry. dW[l] sums
    the type's n exact products x * dz in f32, across blocks by atomics,
    in another order on every run: elementwise within gamma_n of their sum
    of |product| (+ n FLT_MIN, the atomics flush subnormals) from the f64
    sum of the kernel-order dz, a guard against blow-ups only, since at n
    near 10^5 that exceeds a typical |dW|; and per type by norm,
    |dW - dW_plain| <= 1e-4 |dW_plain| + |x_l^T (dz - dz_plain)| (the
    second term the exact change that the kernel-order dz makes; rounding
    errors of f32 sums of n terms grow about as sqrt(n) u, 2e-5 of the
    norm at n = 10^5). Returns the larger max |kernel - plain|."""
    (dx, dw), (dx_want, dw_want) = got, want
    n_types = w.shape[0]
    valid = ((types >= 0) & (types < n_types))[:, None]
    g = g16.index_select(0, ranks).float()
    dact = rs._ACTS[act][1]

    def dz_of(y):
        return torch.where(valid, dact(y) * g, 0.0).to(torch.bfloat16)

    dz = dz_of(kernel_order_products(torch, x, w, types))
    dz_plain = dz_of(rs._typed_products(x, w, types))
    dx_ko = kernel_order_products(torch, dz, w.transpose(1, 2), types).to(
        torch.bfloat16)
    err = (dx.double() - dx_want.double()).abs()
    allowed = (dx_ko.double() - dx_want.double()).abs()
    bad = int((err > allowed).sum())
    bad_w, worst_norm = 0, 0.0
    err_w = (dw.double() - dw_want.double()).abs()
    for l in range(n_types):
        sel = (types == l).nonzero(as_tuple=True)[0]
        xl = x.index_select(0, sel).double()
        dzl = dz.index_select(0, sel).double()
        n = sel.numel()
        gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
        ref = xl.t() @ dzl
        bad_w += int(((dw[l].double() - ref).abs()
                      > gamma * (xl.abs().t() @ dzl.abs())
                      + n * 2.0 ** -126).sum())
        moved = float(torch.linalg.norm(
            xl.t() @ (dzl - dz_plain.index_select(0, sel).double())))
        want_norm = float(torch.linalg.norm(dw_want[l].double()))
        diff = float(torch.linalg.norm(dw[l].double() - dw_want[l].double()))
        if diff > 1e-4 * want_norm + moved:
            bad_w += 1
        worst_norm = max(worst_norm, diff / max(want_norm, 1e-30))
    print("  typed_dense_agg_bwd: max |kernel - plain| = %.3e (dx; %d "
          "entries the kernel's order rounds apart), %.3e (dW; |dW - "
          "dW_plain| / |dW_plain| <= %.3e per type); entries over the "
          "bound: %d, %d" % (float(err.max()), int((allowed > 0).sum()),
                             float(err_w.max()), worst_norm, bad, bad_w))
    if (bad or bad_w or not bool(torch.isfinite(dx.float()).all())
            or not bool(torch.isfinite(dw).all())):
        raise AssertionError("typed_dense_agg_bwd disagrees with its plain "
                             "version")
    return max(float(err.max()), float(err_w.max()))


def emlp1_src_bwd_terms(torch, rs, gcb, t_rows, cols, w, e_real, act):
    """K14's per-edge terms as the kernel computes them, f32 [E, D]: x =
    elu(m + beta), y = bf16(x) @ W[col] and dx = da @ W[col]^T summed in
    its order, da = bf16(act'(y) * g), the term bf16(elu'(x) * dx); 0 at
    or past e_real and for an edge of no non-self type."""
    d = t_rows.shape[1]
    g = gcb.float()
    x = rs._elu(t_rows.float() + g[:, :d])
    y = kernel_order_products(torch, x.to(torch.bfloat16), w, cols)
    da = torch.where((cols >= 0)[:, None], rs._ACTS[act][1](y) * g[:, d:],
                     0.0).to(torch.bfloat16)
    dx = kernel_order_products(torch, da, w.transpose(1, 2), cols)
    live = ((torch.arange(cols.shape[0], device=cols.device)
             < e_real.to(cols.device)) & (cols >= 0))[:, None]
    return rs._bf16_terms(torch.where(
        live, rs._ACTS_FROM_OUT["elu"](x) * dx, 0.0))


def emlp1_src_bwd_bounds(torch, rs, gcb, t, cols, w, e_real, ranks, rows,
                         act):
    """(sum of |term|, number of terms, slack) per entry of K14's output,
    for check_kernel (term_ulps=0): the terms in the kernel's order
    (emlp1_src_bwd_terms) and in the plain version's (its plain version
    with every edge a rank of its own), and as slack the per-entry sum of
    their differences."""
    e = ranks.shape[0]
    t_rows = t.index_select(0, ranks)
    c = cols.index_select(0, ranks.long())
    t_ko = emlp1_src_bwd_terms(torch, rs, gcb, t_rows, c, w, e_real, act)
    t_p = rs._emlp1_src_bwd_plain(gcb, t_rows, c, w, e_real,
                                  torch.arange(e, device=gcb.device), e, act)
    counts = torch.zeros(rows, device=gcb.device).index_add_(
        0, ranks, torch.ones(e, device=gcb.device))
    return (per_row(torch, rows, ranks, torch.maximum(t_ko.abs(), t_p.abs())),
            counts, per_row(torch, rows, ranks, (t_ko - t_p).abs()))


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

    def dw_check(name, stream):
        """d_w_t [K, E] is an f32 sum of D / K exact products (the first D
        columns of `stream` times the receiver's cotangent row) in another
        order than the plain version's."""
        def check(dw, dw_want):
            prods = (stream[:, :d].float()
                     * g7.float().index_select(0, rcv)).abs()
            sums = prods.reshape(e, heads, -1).sum(-1).t()
            return check_kernel(
                name, dw.reshape(-1, 1), dw_want.reshape(-1, 1),
                sums.reshape(-1, 1),
                torch.full((e * heads,), float(d // heads), device=dev),
                torch)
        return check

    def wseg_bwd_check(got, want):
        """K7b: d_msgs must equal the plain version's."""
        (dm, dw), (dm_want, dw_want) = got, want
        err_m = exact_check("wseg_t_bwd d_msgs")(dm.float(), dm_want.float())
        return max(err_m, dw_check("wseg_t_bwd d_w_t", m7)(dw, dw_want))

    def film_bwd_check(got, want):
        """K4: d_msgs must equal the plain version's; d_gb as K2."""
        (dm, dgb), (dm_want, dgb_want) = got, want
        err_m = exact_check("film_bwd d_msgs")(dm.float(), dm_want.float())
        return max(err_m, order_check("film_bwd d_gb", rpad, fine, k2_terms)(
            dgb, dgb_want))

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
    # K8 / K9 inputs, as the fused RGAT backward builds them: the [E, D+K]
    # gathered stream (K8 reads its first D columns); the [E, D+3K] side
    # stream of K9 (cotangent | target logits | a positive denominator |
    # correction) and the [R_src, D+K] t | lsrc table.
    m8 = randn(e, d + heads)
    gcb9 = torch.randn((e, d + 3 * heads), generator=gen, device=dev)
    gcb9[:, d + heads:d + 2 * heads] = 0.5 + 4 * torch.rand(
        (e, heads), generator=gen, device=dev)
    gcb9 = gcb9.to(torch.bfloat16)
    t9 = randn(rsrc, d + heads)
    k9_abs, k9_counts, k9_slack = rgat_src_bwd_bounds(
        torch, rs, gcb9, t9, src, rsrc, heads)
    k9_terms = rs._rgat_src_bwd_plain(
        gcb9, t9.index_select(0, src), torch.arange(e, device=dev), e, heads,
        50.0)  # edge by edge, for the index_add_ yardstick
    film_yardstick = ("torch.Tensor.index_add_ of the precomputed terms "
                      "(leaves out the row gathers, the modulation and the "
                      "activation)")
    # K11 / K12 inputs, as GNN-Edge-MLP1 builds them over the type-major
    # stream: bf16 streams, the f32 beta table and the bf16 table cotangent
    # over the (type, receiver) ranks; K11 runs elu, K12 gelu. K12 is
    # called once per streamed edge type on that type's slice: the specs
    # time the largest slice, `also` checks every slice and the whole
    # stream, and `extra` times the other slices and the whole stream.
    tm, offs = flat.tm_rank, flat.tm_offs
    if flat.tm_self != QM9_TM_SELF:
        raise AssertionError("QM9 self-loop types %s" % (flat.tm_self,))
    n_tm = int(tm[-1]) + 1
    slices = {l: (offs[l], offs[l + 1]) for l in range(len(offs) - 1)
              if not flat.tm_self[l]}
    big = max(slices, key=lambda l: slices[l][1] - slices[l][0])
    print("type-major stream: %d (type, receiver) groups; slices %s, self-"
          "loop types %s; K12 timed on type %d" % (
              n_tm, [b - a for a, b in zip(offs[:-1], offs[1:])],
              [l for l, s_ in enumerate(flat.tm_self) if s_], big))
    m11, x11, dx11, y12 = randn(e, d), randn(e, d), randn(e, d), randn(e, d)
    beta11 = torch.randn((rpad, d), generator=gen, device=dev)
    g12 = randn(rpad, d)
    gelu, dgelu = rs._ACTS["gelu"]
    dz11 = rs._expand_add_act_bwd_plain(x11, dx11, tm, rpad, "elu")[0].float()
    table12 = torch.zeros((rpad, d), device=dev)  # K12a's shared table
    k12_terms = rs._bf16_terms(gelu(y12.float()))
    dgelu12 = dgelu(y12.float())

    def k12(lo, hi):
        """K12a and K12b specs on the stream slice [lo, hi)."""
        el = hi - lo
        msg, ranks = y12[lo:hi], tm[lo:hi]
        n_l = int(ranks[-1]) - int(ranks[0]) + 1
        terms, dact_l = k12_terms[lo:hi], dgelu12[lo:hi]
        counts_l = torch.zeros(rpad, device=dev).index_add_(
            0, ranks, torch.ones(el, device=dev))
        abs_l = torch.zeros((rpad, d), device=dev).index_add_(0, ranks,
                                                             terms.abs())
        return (
            # K12a reads the slice's messages and ranks and writes the
            # slice's rank rows of a table that the caller zeroed once for
            # all slices (`out`, as act_ranked_aggregate_slices calls it:
            # that is what is timed; the check runs on a table of its own);
            # gelu through the erf polynomial is about 30 operations an
            # element.
            dict(name="act_agg",
                 kern=lambda: rs._act_agg_impl(msg, ranks, table_rows=rpad,
                                               act="gelu"),
                 timed=lambda: rs._act_agg_impl(msg, ranks, table_rows=rpad,
                                                act="gelu", out=table12),
                 plain=lambda: rs._act_agg_plain(msg, ranks, rpad, "gelu"),
                 check=lambda got, want: check_kernel(
                     "act_agg [%d:%d]" % (lo, hi), got, want, abs_l, counts_l,
                     torch),
                 nbytes=el * d * 2 + el * 4 + n_l * d * 4, nops=30 * el * d,
                 yardstick=("torch.Tensor.index_add_ of the precomputed "
                            "terms (leaves out the activation)",
                            lambda: torch.zeros((rpad, d), device=dev
                                                ).index_add_(0, ranks, terms))),
            # K12b reads the messages, the ranks and the used rows of the
            # bf16 cotangent table and writes [E_l, D] bf16; gelu' is about
            # 45 operations an element.
            dict(name="act_agg_bwd",
                 kern=lambda: rs._act_agg_bwd_impl(msg, g12, ranks,
                                                   act="gelu"),
                 plain=lambda: rs._act_agg_bwd_plain(msg, g12, ranks, "gelu"),
                 check=exact_check("act_agg_bwd [%d:%d]" % (lo, hi)),
                 nbytes=2 * el * d * 2 + el * 4 + n_l * d * 2,
                 nops=45 * el * d,
                 yardstick=("index_select of the cotangent rows times the "
                            "precomputed derivative, rounded (three PyTorch "
                            "calls; leaves out gelu')",
                            lambda: (dact_l * g12.index_select(0, ranks)
                                     .float()).to(torch.bfloat16))))

    def eaa_bwd_check(got, want):
        """K11b: d_m must equal the plain version's; d_beta sums it."""
        (dm, dbeta), (dm_want, dbeta_want) = got, want
        err_m = exact_check("expand_add_act_bwd d_m")(dm.float(),
                                                      dm_want.float())
        return max(err_m, order_check("expand_add_act_bwd d_beta", rpad, tm,
                                      dz11)(dbeta, dbeta_want))

    # K10 inputs, as GNN-Edge-MLP1's fused1 branch builds them (gelu): the
    # bf16 hidden stream over the receiver-sorted edges, the edge types,
    # the five types' bf16 W1 and the bf16 coarse table cotangent. The
    # "other" compositions sort by type first (the split sizes are the
    # batch's, known before the step, as the type-major view's offsets).
    types = flat.edge_type
    n_types = graph.num_edge_types
    x10, g10 = randn(e, d), randn(rows, d)
    w10 = (torch.randn((n_types, d, d), generator=gen, device=dev)
           / math.sqrt(d)).to(torch.bfloat16)
    k10_abs, k10_counts, k10_slack = typed_dense_agg_bounds(
        torch, rs, x10, w10, types, rcv, rows, "gelu")
    sizes10 = torch.bincount(types, minlength=n_types).tolist()

    def k10a_other():
        order = torch.argsort(types, stable=True)
        parts = torch.split(x10.index_select(0, order), sizes10)
        y = torch.cat([torch.matmul(p, w10[l]) for l, p in enumerate(parts)])
        return torch.zeros((rows, d), device=dev).index_add_(
            0, rcv.index_select(0, order),
            torch.nn.functional.gelu(y.float()).to(torch.bfloat16).float())

    def k10b_other():
        order = torch.argsort(types, stable=True)
        xs = torch.split(x10.index_select(0, order), sizes10)
        gs = torch.split(g10.index_select(0, rcv.index_select(0, order)),
                         sizes10)
        dxs, dws = [], []
        for l, (xp, gp) in enumerate(zip(xs, gs)):
            dz = (dgelu(torch.matmul(xp, w10[l]).float())
                  * gp.float()).to(torch.bfloat16)
            dxs.append(torch.matmul(dz, w10[l].t()))
            dws.append(torch.matmul(xp.t().float(), dz.float()))
        return (torch.empty_like(x10).index_copy_(0, order, torch.cat(dxs)),
                torch.stack(dws))

    # K14 inputs, as the fused_src1 backward builds them: the bf16 beta | g
    # stream over the src-sorted edges, the bf16 t table over src ranks,
    # each src rank's compact non-self type, the four streamed types' bf16
    # weights and the real-edge count.
    gcb14, t14 = randn(e, 2 * d), randn(rsrc, d)
    cols14 = rs.src_rank_type_columns(flat.src_from_rank, graph.n_pad,
                                      flat.tm_self)
    w14 = (torch.randn((QM9_STREAMED_TYPES, d, d), generator=gen, device=dev)
           / math.sqrt(d)).to(torch.bfloat16)
    e_real14 = flat.mask.sum().to(torch.int32).reshape(1)
    e14_live = int(((cols14.index_select(0, src.long()) >= 0)
                    & (torch.arange(e, device=dev) < e_real14)).sum())
    k14_abs, k14_counts, k14_slack = emlp1_src_bwd_bounds(
        torch, rs, gcb14, t14, cols14, w14, e_real14, src, rsrc, "gelu")
    k14_terms = rs._emlp1_src_bwd_plain(
        gcb14, t14.index_select(0, src), cols14.index_select(0, src.long()),
        w14, e_real14, torch.arange(e, device=dev), e, "gelu")

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
        # K4 is K2 plus the bf16 [E, D] message cotangent it writes.
        dict(name="film_bwd",
             kern=lambda: rs._film_bwd_impl(msgs, gbg, fine, act=act),
             plain=lambda: rs._film_bwd_plain(msgs, gbg, fine, act),
             check=film_bwd_check,
             nbytes=(2 * e * d * 2 + e * 4 + n_fine * 3 * d * 2
                     + rpad * 2 * d * 4),
             nops=8 * e * d,
             yardstick=(film_yardstick, index_add(rpad, fine, k2_terms))),
        # K8 reads the first D columns of the [E, D+K] stream, the ranks and
        # the used rows of the bf16 cotangent table and writes [K, E] f32; a
        # multiply and an add per element.
        dict(name="wseg_t_dw",
             kern=lambda: rs._wseg_t_dw_impl(m8, g7, rcv, num_heads=heads,
                                             d_used=d),
             plain=lambda: rs._wseg_t_dw_plain(m8, g7, rcv, heads, d),
             check=dw_check("wseg_t_dw", m8),
             nbytes=e * d * 2 + heads * e * 4 + e * 4 + n_rcv * d * 2,
             nops=2 * e * d,
             yardstick=("index_select of the cotangent rows, a multiply and "
                        "a per-head sum (three PyTorch calls, on a stream "
                        "already cut to D columns)",
                        lambda: (m7.float() * g7.index_select(0, rcv).float()
                                 ).reshape(e, heads, -1).sum(-1))),
        # K9 reads the [E, D+3K] side stream, the ranks and the used rows of
        # the t | lsrc table and writes the [R_src, D+K] table; per column a
        # product for the head's dot, one for the term and two adds, per
        # head the softmax recompute.
        dict(name="rgat_src_bwd",
             kern=lambda: rs._rgat_src_bwd_impl(
                 gcb9, t9, src, table_rows=rsrc, num_heads=heads, clamp=50.0),
             plain=lambda: rs._rgat_src_bwd_plain(gcb9, t9, src, rsrc, heads,
                                                  50.0),
             check=lambda got, want: check_kernel(
                 "rgat_src_bwd", got, want, k9_abs, k9_counts, torch,
                 term_ulps=1, slack=k9_slack),
             nbytes=(e * (d + 3 * heads) * 2 + e * 4
                     + n_src * (d + heads) * 2 + rsrc * (d + heads) * 4),
             nops=5 * e * d + 16 * e * heads,
             yardstick=("torch.Tensor.index_add_ of the precomputed terms "
                        "(leaves out the row gathers and the attention "
                        "recompute)", index_add(rsrc, src, k9_terms))),
        # K11a reads the bf16 stream, the ranks and the used rows of the f32
        # table and writes [E, D] bf16; a rounding, an add and elu.
        dict(name="expand_add_act",
             kern=lambda: rs._expand_add_act_impl(m11, beta11, tm, act="elu"),
             plain=lambda: rs._expand_add_act_plain(m11, beta11, tm, "elu"),
             check=lambda got, want: exact_check("expand_add_act")(
                 got.float(), want.float()),
             nbytes=2 * e * d * 2 + e * 4 + n_tm * d * 4, nops=12 * e * d,
             yardstick=("index_select of the table rows, an add, elu and a "
                        "cast (PyTorch calls on f32 [E, D] intermediates; "
                        "the table is not rounded)",
                        lambda: torch.nn.functional.elu(
                            m11.float() + beta11.index_select(0, tm)
                        ).to(torch.bfloat16))),
        # K11b reads two bf16 streams and the ranks and writes d_m (bf16)
        # and the whole zeroed f32 d_beta table.
        dict(name="expand_add_act_bwd",
             kern=lambda: rs._expand_add_act_bwd_impl(
                 x11, dx11, tm, table_rows=rpad, act="elu"),
             plain=lambda: rs._expand_add_act_bwd_plain(x11, dx11, tm, rpad,
                                                        "elu"),
             check=eaa_bwd_check,
             nbytes=3 * e * d * 2 + e * 4 + rpad * d * 4, nops=4 * e * d,
             yardstick=("torch.Tensor.index_add_ of the precomputed dz "
                        "(leaves out the derivative and the d_m store)",
                        index_add(rpad, tm, dz11))),
        *k12(*slices[big]),
        # K10a reads the bf16 stream, the types, the ranks and the weights
        # and writes the used table rows; per element of the output a
        # D-long product (on the tensor cores: 2 E D^2 bf16 operations)
        # and gelu.
        dict(name="typed_dense_agg",
             kern=lambda: rs._typed_dense_agg_impl(x10, w10, types,
                                                   rcv, table_rows=rows,
                                                   act="gelu"),
             plain=lambda: rs._typed_dense_agg_plain(x10, w10, types, rcv,
                                                     rows, "gelu"),
             check=lambda got, want: check_kernel(
                 "typed_dense_agg", got, want, k10_abs, k10_counts, torch,
                 slack=k10_slack),
             nbytes=(e * d * 2 + 2 * e * 4 + n_types * d * d * 2
                     + n_rcv * d * 4),
             nops=30 * e * d, tensor_ops=2 * e * d * d,
             yardstick=("a stable sort by type, one torch.matmul per type, "
                        "gelu and index_add_", k10a_other)),
        # K10b reads the stream, the types, the ranks, the weights and the
        # used rows of the bf16 cotangent table and writes dx (bf16) and
        # dW (f32); three D-long products per element (6 E D^2 bf16
        # operations on the tensor cores) and gelu'.
        dict(name="typed_dense_agg_bwd",
             kern=lambda: rs._typed_dense_agg_bwd_impl(x10, w10, g10, types,
                                                       rcv, act="gelu"),
             plain=lambda: rs._typed_dense_agg_bwd_plain(x10, w10, g10,
                                                         types, rcv, "gelu"),
             check=lambda got, want: typed_dense_agg_bwd_check(
                 torch, rs, got, want, x10, w10, g10, types, rcv, "gelu"),
             nbytes=(2 * e * d * 2 + 2 * e * 4 + n_rcv * d * 2
                     + n_types * d * d * (2 + 4)),
             nops=45 * e * d, tensor_ops=6 * e * d * d,
             yardstick=("the matching composition: a stable sort by type, "
                        "a row gather of the cotangent, three torch.matmul "
                        "per type, gelu' and index_copy_", k10b_other)),
        # K14 reads the [E, 2D] beta | g stream, the ranks, the used rows
        # of the t table and of the type column and the weights and writes
        # the src-rank table; two D-long products per element of a live
        # edge of a streamed type (4 E_live D^2 bf16 operations) and the
        # elu / gelu' recompute.
        dict(name="emlp1_src_bwd",
             kern=lambda: rs._emlp1_src_bwd_impl(
                 gcb14, t14, cols14, w14, e_real14, src, table_rows=rsrc,
                 act="gelu"),
             plain=lambda: rs._emlp1_src_bwd_plain(
                 gcb14, t14, cols14, w14, e_real14, src, rsrc, "gelu"),
             check=lambda got, want: check_kernel(
                 "emlp1_src_bwd", got, want, k14_abs, k14_counts, torch,
                 slack=k14_slack),
             nbytes=(e * 2 * d * 2 + e * 4 + n_src * (d * 2 + 4)
                     + 4 * d * d * 2 + rsrc * d * 4),
             nops=60 * e * d, tensor_ops=4 * e14_live * d * d,
             yardstick=("torch.Tensor.index_add_ of the precomputed terms "
                        "(leaves out the row gathers and the two typed "
                        "products per edge)", index_add(rsrc, src, k14_terms))),
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
    # K12 on the other streamed types' slices and over the whole stream
    # (self-loop slice included): checked, then timed into `extra`.
    extra = {"act_agg": {}, "act_agg_bwd": {}}
    others = [("type %d" % l, rng_) for l, rng_ in slices.items() if l != big]
    others.append(("whole stream", (0, e)))

    def k12_also(which):
        def run():
            worst = 0.0
            for label, (lo, hi) in others:
                spec = k12(lo, hi)[which]
                got = spec["kern"]()
                torch.cuda.synchronize()
                worst = max(worst, spec["check"](got, spec["plain"]()))
                timed = spec.get("timed", spec["kern"])
                extra[spec["name"]][label] = {
                    "edges": hi - lo, "ms": cuda_ms(timed, torch),
                    "queued_ms": cuda_queued_ms(timed, torch),
                    "plain_ms": cuda_ms(spec["plain"], torch),
                    "bound_ms": max(spec["nbytes"] / HBM_BYTES_PER_S,
                                    spec["nops"] / F32_FLOPS) * 1e3}
            return worst
        return run

    also["act_agg"] = k12_also(0)
    also["act_agg_bwd"] = k12_also(1)
    results = []
    for spec in specs:
        name = spec["name"]
        got = spec["kern"]()
        torch.cuda.synchronize()
        max_err = spec["check"](got, spec["plain"]())
        if name in also:
            max_err = max(max_err, also[name]())
        timed = spec.get("timed", spec["kern"])
        ms = cuda_ms(timed, torch)
        plain_ms = cuda_ms(spec["plain"], torch)
        bound_bytes_ms = spec["nbytes"] / HBM_BYTES_PER_S * 1e3
        # Elementwise work at the f32 rate; typed products (K10, K14) at
        # the bf16 tensor-core rate, the least time they could take.
        bound_ops_ms = max(spec["nops"] / F32_FLOPS,
                           spec.get("tensor_ops", 0) / BF16_TENSOR_FLOPS) * 1e3
        bound_ms = max(bound_bytes_ms, bound_ops_ms)
        row = {
            "name": name, "route": "cuda",
            "source": "tf_gnn_samples_torch/csrc/%s.cu" % name,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": None,
            "queued_ms": cuda_queued_ms(timed, torch),
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
        # The bound's two terms, and for K10 and K14 what their typed
        # products take at the f32 rate (the kernels form them with scalar
        # f32 multiplies and adds): computed, not measured, so printed
        # here and kept out of the kernels line.
        products = ("; the typed products at the f32 rate %.4f ms"
                    % (spec["tensor_ops"] / F32_FLOPS * 1e3)
                    if "tensor_ops" in spec else "")
        print("  %s: kernel %.4f ms (%.4f ms queued behind a busy card), "
              "plain %.4f ms; bound %.4f ms = max(bytes %.4f ms, operations "
              "%.4f ms) (%d bytes at 3.35 TB/s; %d f32 ops at 67 TFLOP/s; "
              "%d bf16 tensor-core ops at 989 TFLOP/s%s); %s"
              % (name, ms, row["queued_ms"], plain_ms, bound_ms,
                 bound_bytes_ms, bound_ops_ms, spec["nbytes"], spec["nops"],
                 spec.get("tensor_ops", 0), products, other))
        if name in extra:
            # The row is the largest slice; the main path launches the
            # kernel once per streamed type, so a launch's mean time over
            # those slices is what a step's kernel share is counted with.
            row["edges"] = slices[big][1] - slices[big][0]
            row["other_shapes"] = extra[name]
            per_type = [v for k, v in extra[name].items()
                        if k != "whole stream"]
            row["mean_slice_ms"] = statistics.mean(
                [ms] + [v["ms"] for v in per_type])
            row["mean_slice_queued_ms"] = statistics.mean(
                [row["queued_ms"]] + [v["queued_ms"] for v in per_type])
            print("  %s on its other shapes: %s; mean over the streamed "
                  "types' slices %.4f ms (%.4f queued)"
                  % (name, json.dumps(extra[name]), row["mean_slice_ms"],
                     row["mean_slice_queued_ms"]))
        results.append(row)
    return results


def ppi_like_graph(dev, seed=0, num_nodes=8192, degree=14):
    """A numpy-made graph of PPI-like degree on `dev`: `degree` random
    in-edges per node, their reverses as a second type and a self-loop
    type, padded by the port's own pad_graph_batch to whole 2048-edge
    rows."""
    import numpy as np

    from tf_gnn_samples_torch.ops.graph import graph_to_device, pad_graph_batch

    rng = np.random.RandomState(seed)
    fwd = rng.randint(0, num_nodes, size=(num_nodes * degree, 2)).astype(
        np.int32)
    loops = np.stack([np.arange(num_nodes)] * 2, 1).astype(np.int32)
    adj = [fwd, fwd[:, ::-1].copy(), loops]
    feats = rng.randn(num_nodes, 8).astype(np.float32)
    return graph_to_device(pad_graph_batch(
        feats, adj, np.zeros(num_nodes, np.int32), 1,
        e_pads=[-(-a.shape[0] // 2048) * 2048 for a in adj]), dev)


def diluted_phase(torch, rs, dev, graph, seed=0):
    """K3, K9 and K14 on a DILUTED src stream. The tuned QM9 batches have no
    fine rank window, so their src streams are undiluted; `graph`
    (ppi_like_graph) dilutes. Fill slots carry the SD_FILL key, which the
    passes clamp onto a zero row appended to their side table: both
    kernels are held against their plain versions on that stream, and the
    rows no real edge feeds must be exactly zero."""
    from tf_gnn_samples_torch.nn.layers import src_stream
    from tf_gnn_samples_torch.ops.graph import SD_FILL

    flat = graph.flat
    fine, ranks, win = src_stream(flat)
    n_fill = int((fine == int(SD_FILL)).sum())
    e, e_sd = int(flat.src_flat.numel()), int(ranks.numel())
    print("diluted stream: E=%d, %d slots of which %d fill, window %d "
          "(fine window %d, undiluted src window %d)"
          % (e, e_sd, n_fill, win, flat.win_fine, flat.win_src))
    if not (flat.win_sd and fine is flat.sd_fine and n_fill and e_sd > e):
        raise AssertionError("the src stream did not dilute")
    d, heads, act = 128, 8, "elu"
    rpad = int(flat.fine_to_flat.numel())
    rsrc = int(flat.src_from_rank.numel())
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def gathered(side):
        return rs._zero_extended(side).index_select(0, fine.clamp(max=rpad))

    ones = torch.ones(e_sd, device=dev)
    counts = torch.zeros(rsrc, device=dev).index_add_(0, ranks, ones)
    fed = torch.zeros(rsrc, device=dev).index_add_(
        0, ranks, (fine != int(SD_FILL)).float()) > 0
    every = torch.arange(e_sd, device=dev)

    def check(name, got, want, abs_sums, **allow):
        check_kernel(name + " (diluted)", got, want, abs_sums, counts, torch,
                     **allow)
        if bool((got[~fed] != 0).any()):
            raise AssertionError("%s: fill slots reached the table" % name)

    gcb3, t3 = gathered(randn(rpad, 3 * d)), randn(rsrc, d)
    k3_terms = rs._film_src_bwd_plain(gcb3, t3.index_select(0, ranks), every,
                                      e_sd, act)  # edge by edge
    check("film_src_bwd",
          rs._film_src_bwd_impl(gcb3, t3, ranks, table_rows=rsrc, act=act),
          rs._film_src_bwd_plain(gcb3, t3, ranks, rsrc, act),
          torch.zeros((rsrc, d), device=dev).index_add_(0, ranks,
                                                        k3_terms.abs()))
    side = torch.randn((rpad, d + 3 * heads), generator=gen, device=dev)
    side[:, d + heads:d + 2 * heads] = 0.5 + 4 * torch.rand(
        (rpad, heads), generator=gen, device=dev)
    gcb9, t9 = gathered(side.to(torch.bfloat16)), randn(rsrc, d + heads)
    k9_abs, _, k9_slack = rgat_src_bwd_bounds(torch, rs, gcb9, t9, ranks,
                                              rsrc, heads)
    check("rgat_src_bwd",
          rs._rgat_src_bwd_impl(gcb9, t9, ranks, table_rows=rsrc,
                                num_heads=heads, clamp=50.0),
          rs._rgat_src_bwd_plain(gcb9, t9, ranks, rsrc, heads, 50.0),
          k9_abs, term_ulps=1, slack=k9_slack)
    # K14 on the diluted stream: the graph's self-loop type has no column;
    # fill slots carry zero beta | g rows.
    cols14 = rs.src_rank_type_columns(flat.src_from_rank, graph.n_pad,
                                      flat.tm_self)
    n_types = graph.num_edge_types
    gcb14 = randn(e_sd, 2 * d)
    gcb14[fine == int(SD_FILL)] = 0
    t14 = randn(rsrc, d)
    w14 = (torch.randn((n_types - 1, d, d), generator=gen, device=dev)
           / math.sqrt(d)).to(torch.bfloat16)
    e_real = torch.tensor([e_sd], dtype=torch.int32, device=dev)
    k14_abs, _, k14_slack = emlp1_src_bwd_bounds(
        torch, rs, gcb14, t14, cols14, w14, e_real, ranks, rsrc, "gelu")
    check("emlp1_src_bwd",
          rs._emlp1_src_bwd_impl(gcb14, t14, cols14, w14, e_real, ranks,
                                 table_rows=rsrc, act="gelu"),
          rs._emlp1_src_bwd_plain(gcb14, t14, cols14, w14, e_real, ranks,
                                  rsrc, "gelu"),
          k14_abs, slack=k14_slack)
    torch.cuda.synchronize()


def rgat_branch_phase(torch, rs, dev, ppi_graph):
    """RGAT's two kernel branches in turns (fused, streamed, streamed,
    fused, twice over) within this one run: the device time of one train
    and one eval step of the tuned model on one tuned QM9 batch (E below
    the type-stacked node table's L * n_pad rows), and of one layer's
    forward and backward at the same width on `ppi_graph`, whose edge
    stream is about ten times its node table. A turn's figure is the
    median of 10 CUDA-event timings; reported are each branch's median
    over its four turns and in how many of the four neighbouring pairs of
    turns the fused branch was the faster one. Both steps wait for the
    host much of the time, so each branch's device-busy time per train
    step and per layer pass (`device_busy_ms`) is read too."""
    from tf_gnn_samples_torch.nn.layers import rgat_apply, rgat_init
    from tf_gnn_samples_torch.runtime.model import batch_to_device
    from tf_gnn_samples_torch.train import HYPERS_DIR
    from tf_gnn_samples_torch.utils.registry import name_to_model_class

    cls, _ = name_to_model_class("RGAT")
    with open(os.path.join(HYPERS_DIR, "QM9_RGAT.json")) as f:
        params = dict(cls.default_params(), **json.load(f)["model_params"])
    task, batch = first_batch(params["max_nodes_in_batch"], "TRAIN")
    out = os.path.join(OUT, "RGAT-branches")
    os.makedirs(out, exist_ok=True)
    model = cls(params, task, "ab", out, device=dev)
    dev_batch = batch_to_device(batch, model.device)
    heads, dim = params["num_heads"], params["hidden_size"]
    gen = torch.Generator().manual_seed(0)
    layer = {k: v.to(dev).requires_grad_(True) for k, v in rgat_init(
        gen, ppi_graph.num_edge_types, dim, num_heads=heads).items()}
    h = torch.randn((ppi_graph.n_pad, dim), generator=gen).to(dev)
    h.requires_grad_(True)

    def layer_step():
        y = rgat_apply(layer, ppi_graph, h, num_heads=heads,
                       activation_function="elu")
        torch.autograd.grad(y.sum(), [h] + list(layer.values()))

    work = {"train_step_ms": lambda: model._train_step(dev_batch),
            "eval_step_ms": lambda: model._eval_step(dev_batch),
            "ppi_layer_fwd_bwd_ms": layer_step}
    times = {True: collections.defaultdict(list),
             False: collections.defaultdict(list)}
    for fused in (True, False, False, True) * 2:
        with rgat_branch(rs, fused):
            for name, fn in work.items():
                times[fused][name].append(cuda_ms(fn, torch, warmup=2,
                                                  iters=10))
    result = {("fused" if fused else "streamed"): {
        name: statistics.median(v) for name, v in t.items()}
        for fused, t in times.items()}
    result["pairs_fused_faster_of_4"] = {
        name: sum(f < s for f, s in zip(times[True][name],
                                        times[False][name]))
        for name in work}
    for fused in (True, False):
        with rgat_branch(rs, fused):
            result["fused" if fused else "streamed"].update(
                train_step_busy_ms=device_busy_ms(work["train_step_ms"],
                                                  torch),
                ppi_layer_busy_ms=device_busy_ms(layer_step, torch))
    e_qm9 = int(dev_batch.graph.flat.src_flat.numel())
    e_ppi = int(ppi_graph.flat.src_flat.numel())
    print("RGAT branches in turns: tuned QM9 batch (E=%d, L*n_pad=%d) and "
          "PPI-like layer (E=%d, L*n_pad=%d): %s"
          % (e_qm9, dev_batch.graph.num_edge_types * dev_batch.graph.n_pad,
             e_ppi, ppi_graph.num_edge_types * ppi_graph.n_pad,
             json.dumps(result)))
    return result


def finite_log_values(path, pattern):
    """Float values of `pattern`'s group 1 in a run log; all finite."""
    with open(path) as f:
        vals = [float(m.group(1)) for m in map(pattern.match, f) if m]
    if not vals or not all(math.isfinite(v) for v in vals):
        raise AssertionError("%s: values %s in %s" % (pattern.pattern, vals,
                                                      path))
    return vals


def expected_launches(label, layers, n_fwd, n_bwd):
    """Kernel launches of `n_fwd` forward passes, `n_bwd` of them with a
    backward pass, through `layers` message-passing layers of the path
    `label`; no other kernel runs. GNN-FiLM runs K1 forward and K2 + K3
    backward; with normalised messages K1 forward and, backward, K4 and
    K5a (the message gather's backward). RGCN and GGNN run K5a forward and
    K5b backward. An RGAT layer runs, forward, K6b for the target logits,
    K6a and K6b for the softmax denominator and K7a, on either branch;
    backward, the streamed branch runs K7b, the VJPs of those three K6
    launches (K6a twice, K6b once) and K5a in the message gather's
    backward, the fused branch K8, K6a and K6b for the softmax correction,
    K6a for the target logits' cotangent and K9. GNN-Edge-MLP0 is the
    fused FiLM pass (K1; K2 and K3). A GNN-Edge-MLP1 layer runs K11a once
    and K12a once per streamed edge type forward; backward K12b per
    streamed type, K11b and K5a (the type-major gather's backward), or in
    its fused_src1 form K14 in place of that K5a. Its fused1 branch runs
    K5b (the target halves' expand) and K10a forward; K10b and two K5a
    (the backwards of the expand and of the source gather) backward. RGIN
    and GNN-Edge-MLP without the target state run the fused gather +
    segment-sum: K5a forward and K5a backward."""
    want = {k: 0 for k in REPLACES}
    if label in ("RGIN", "GNN-Edge-MLP-ranked"):
        want.update(segsum=layers * (n_fwd + n_bwd))
    elif label == "GNN-Edge-MLP1-fused1":
        want.update(expand=layers * n_fwd, typed_dense_agg=layers * n_fwd,
                    typed_dense_agg_bwd=layers * n_bwd,
                    segsum=2 * layers * n_bwd)
    elif label == "GNN-Edge-MLP1-src":
        want.update(expand_add_act=layers * n_fwd,
                    act_agg=layers * n_fwd * QM9_STREAMED_TYPES,
                    act_agg_bwd=layers * n_bwd * QM9_STREAMED_TYPES,
                    expand_add_act_bwd=layers * n_bwd,
                    emlp1_src_bwd=layers * n_bwd)
    elif label in ("GNN-FiLM", "GNN-Edge-MLP0"):
        want.update(film_fwd=layers * n_fwd, film_bwd_dgb=layers * n_bwd,
                    film_src_bwd=layers * n_bwd)
    elif label == "GNN-FiLM-normalised":
        want.update(film_fwd=layers * n_fwd, film_bwd=layers * n_bwd,
                    segsum=layers * n_bwd)
    elif label == "GNN-Edge-MLP1":
        want.update(expand_add_act=layers * n_fwd,
                    act_agg=layers * n_fwd * QM9_STREAMED_TYPES,
                    act_agg_bwd=layers * n_bwd * QM9_STREAMED_TYPES,
                    expand_add_act_bwd=layers * n_bwd, segsum=layers * n_bwd)
    elif label.startswith("RGAT"):
        want.update(expand_t=layers * (2 * n_fwd + n_bwd),
                    segsum_t=layers * (n_fwd + 2 * n_bwd),
                    wseg_t=layers * n_fwd)
        if label == "RGAT-fused":
            want.update(wseg_t_dw=layers * n_bwd, rgat_src_bwd=layers * n_bwd)
        else:
            want.update(wseg_t_bwd=layers * n_bwd, segsum=layers * n_bwd)
    else:
        want.update(segsum=layers * n_fwd, expand=layers * n_bwd)
    return want


def main_path_phase(rs, path):
    """Train `path.model` at its tuned QM9 config for 2 epochs, test its
    checkpoint; returns the training run's launches, and the step times
    with the launches counted in one train step."""
    from tf_gnn_samples_torch import train as train_cli
    from tf_gnn_samples_torch import test as test_cli
    from tf_gnn_samples_torch.tasks.base import DataFold

    out = os.path.join(OUT, path.label)
    os.makedirs(out, exist_ok=True)
    args = train_cli.get_train_args([
        path.model, "QM9", "--data-path", DATA, "--result-dir", out,
        "--quiet", "--model-param-overrides",
        json.dumps(dict(TUNED_OVERRIDES, **path.overrides))])
    rs.reset_launches()
    t0 = time.time()
    (model,) = train_cli.run(args)
    launches = dict(rs.LAUNCHES)
    train_s = time.time() - t0
    layers = (model.params["graph_num_layers"]
              * model.params["graph_num_timesteps_per_layer"])
    n_train = model.batches_run[DataFold.TRAIN]
    n_valid = model.batches_run[DataFold.VALIDATION]
    want = expected_launches(path.label, layers, n_train + n_valid, n_train)
    print("%s main path: %d train and %d valid batches in %.1f s; launches "
          "%s, expected %s" % (path.label, n_train, n_valid, train_s,
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
    want_test = expected_launches(path.label, layers, n_test, 0)
    print("%s test: %d batches; launches %s, expected %s"
          % (path.label, n_test, test_launches, want_test))
    if test_launches != want_test:
        raise AssertionError("test launches %s != expected %s"
                             % (test_launches, want_test))
    finite_log_values(tmodel.log_file, re.compile(r"^Loss (\S+) on "))
    return launches, step_times(rs, model, path.label)


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


def step_times(rs, model, label):
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
                 lambda: model._train_step(dev_batch), torch),
             "train_step_busy_ms": device_busy_ms(
                 lambda: model._train_step(dev_batch), torch)}
    print("%s: one batch of %d graphs: host packing %.1f ms, train step "
          "%.2f ms, eval step %.2f ms (device timeline); the host enqueues "
          "the train step in %.2f ms; the card is busy %.2f ms of the train "
          "step (idle %.0f%%)"
          % (label, batch.num_graphs, times["pack_ms"],
             times["train_step_ms"], times["eval_step_ms"],
             times["train_step_host_ms"], times["train_step_busy_ms"],
             100 * max(0.0, 1 - times["train_step_busy_ms"]
                       / times["train_step_ms"])))
    return times, step_launches


def reference_phase(torch, rs, path, card="cuda"):
    """Full-width model (tuned config) of `path` on a small QM9 batch: the
    card's kernels against the CPU's plain versions, same weights, no
    dropout. At 600 nodes RGCN and GGNN would take the dense strategy
    ("auto"), so they are set to the ranked one ("pallas") and must launch
    K5; RGAT takes the same branch under either."""
    import numpy as np

    from tf_gnn_samples_torch.runtime.model import batch_to_device, params_to_jax
    from tf_gnn_samples_torch.train import HYPERS_DIR
    from tf_gnn_samples_torch.utils.registry import name_to_model_class

    model_name = path.label
    cls, _ = name_to_model_class(path.model)
    with open(os.path.join(HYPERS_DIR, "QM9_%s.json" % path.model)) as f:
        hypers = json.load(f)["model_params"]
    params = cls.default_params()
    params.update(hypers)
    params.update(path.overrides)
    params["graph_layer_input_dropout_keep_prob"] = 1.0
    if path.model != "GNN-FiLM":
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
    from tf_gnn_samples_torch.nn import layers
    from tf_gnn_samples_torch.ops import cuda_build
    from tf_gnn_samples_torch.ops import ranked_segment as rs

    # Full f32 products in the plain versions and the models, as the
    # runtime sets for its models.
    torch.backends.cuda.matmul.allow_tf32 = False

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
    kernel_ms = {k["name"]: k.get("mean_slice_ms", k["ms"]) for k in kernels}
    queued_ms = {k["name"]: k.get("mean_slice_queued_ms", k["queued_ms"])
                 for k in kernels}
    total = {k["name"]: 0 for k in kernels}
    ppi_graph = ppi_like_graph(torch.device("cuda"))
    diluted_phase(torch, rs, torch.device("cuda"), ppi_graph)
    # RGAT trains with its gate as it is on the branch the gate picks at
    # the tuned batch, and through a forced gate on the other.
    card_default = rs.rgat_fused_supported(161792, 128, 8, 51472, 162056)
    for path in PATHS:
        forced = (None if path.rgat_fused in (None, card_default)
                  else path.rgat_fused)
        print("%s: RGAT gate %s, forced gate %s"
              % (path.label, "as it is" if forced is None
                 else "forced to %s" % forced, path.gate))
        with rgat_branch(rs, forced), forced_gate(rs, layers, path.gate):
            launches, (times, per_step) = main_path_phase(rs, path)
        for name, n in launches.items():
            total[name] += n
        share = sum(n * kernel_ms[k] for k, n in per_step.items())
        queued = sum(n * queued_ms[k] for k, n in per_step.items())
        print("%s: kernel launches counted in one train step %s: %.2f ms at "
              "the single-call times above (%.2f ms at the queued times), "
              "%.1f%% of the train step"
              % (path.label, per_step, share, queued,
                 100 * share / times["train_step_ms"]))
    for k in kernels:
        k["launches"] = total[k["name"]]
    rgat_branch_phase(torch, rs, torch.device("cuda"), ppi_graph)
    for path in PATHS:
        with rgat_branch(rs, path.rgat_fused), forced_gate(rs, layers,
                                                            path.gate):
            reference_phase(torch, rs, path)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
