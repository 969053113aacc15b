#!/usr/bin/env python3
"""Drives the PyTorch port (tf_gnn_samples_torch) on one NVIDIA GPU.

Phases, each of which raises on failure (no phase's failure is caught):
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from tf_gnn_samples_torch/csrc/ with nvcc;
 3. each of the twenty-three kernels (K1 film_fwd, K2 film_bwd_dgb, K3
    film_src_bwd, K4 film_bwd, K5a segsum, K5b expand, K6a segsum_t, K6b
    expand_t, K7a wseg_t, K7b wseg_t_bwd, K8 wseg_t_dw, K9 rgat_src_bwd,
    K10a typed_dense_agg, K10b typed_dense_agg_bwd, K11a expand_add_act,
    K11b expand_add_act_bwd, K12a act_agg, K12b act_agg_bwd, K13a wseg,
    K13b wseg_bwd, K14 emlp1_src_bwd, K15a film_fwd_mask, K15b
    masked_segsum)
    at the shapes of the first training batch of the tuned QM9 configs
    (50,000-node packs; 8 attention heads), held against its plain
    PyTorch version on the card, and timed beside its bound and, where
    one PyTorch call computes the same function, that call; K6a and K6b
    are also held against their plain versions on the second table each
    meets on the RGAT path, K12a and K12b on every edge type's slice of
    the type-major stream (the shapes GNN-Edge-MLP1 gives them; K12a is
    timed on one launch over the four streamed slices, as a layer calls
    it, and on each slice; K12b on the largest) and over the whole
    stream, K15a and K15b for
    relu and leaky_relu (timed with relu; K15a's table also against K1's
    on the same inputs), and K3 (both forms), K9, K14 and K15b on the
    DILUTED src stream of a numpy-made graph of PPI-like degree (QM9's
    streams are undiluted); K1-K4 also against their earlier designs (K1
    / K2: the K16 v3 variants at group 1; K3 / K4: the bodies of
    tools/earlier_designs.py) for elu, as the main path runs them, and
    relu, as the harness times them, K12a against its earlier body (one
    launch a slice) on the layer's four slices and on each, K9 against
    its earlier body at the batch's D 128 with 8 heads and at D 320 with
    4 heads (PPI's width, rows not 16-byte aligned), and K7a against its
    earlier body on the streamed branch's [E, D] stream, on the fused
    branch's [E, D+K] stream through d_used and on that stream at D 320
    with 4 heads (648-byte rows, the 2-byte path): equal on every row of
    at most two chunks; K6a against its earlier body on its receiver and
    its fine table: equal on every row of at most two 8-edge runs; K15a
    (K1's row walk with a mask epilogue, relu and leaky_relu) against its
    earlier body (K1's earlier walk): the mask bit for bit, the table on
    every row of at most two chunks; K15b (every table row written once,
    no zero fill, no atomics; relu and leaky_relu) against its earlier
    body (atomics into a zeroed table): equal on every row of at most two
    chunks, within the order bound on the rest, and through raw launches
    into NaN-filled tables, on the batch and on the diluted stream: every
    row written, the rows no edge reaches exactly 0, two launches equal
    bit for bit (the torch.zeros of its table timed beside it); K10a,
    K10b and K14 (tensor cores,
    gelu) beside their earlier bodies (scalar f32 products): their sums
    take other orders, so each is held to the plain version instead, the
    redesigns within an order-free bound (typed_dense_agg_tc_check,
    typed_dense_agg_bwd_tc_check, emlp1_src_bwd_tc_check: K14's chained
    through da, dx and each term) and the earlier bodies within their
    kernel-order one; each timed beside that design in turns, with its
    queued time over its bound. Library calls and yardstick
    compositions are timed queued too. K7a's fused streams are also held
    against its plain version, and K13a, which shares K7a's body, equal
    to K7a on the same inputs.
    K3 and K9 are timed in their gather forms (as the fused FiLM
    and RGAT backwards call them) and held equal to their stream forms;
    K4 in its split form, held equal to its gamma|beta|g form, its d_gb
    equal to K2's;
 4. K16 (`k16_phase`): the two harnesses of tf_gnn_samples_torch/tools/
    (the A/B variants of K1 and K2, and four row gathers beside
    torch.index_select) at the JAX tools' default shapes and at the tuned
    QM9 batch's, every K16 kernel launched, each variant then held
    against its plain version;
 5. the main paths: `tf_gnn_samples_torch.train` trains GNN-FiLM (with
    and without normalised messages), RGCN, GGNN, RGAT (on its fused and
    on its streamed branch, one of the two through a forced gate), RGIN
    (ranked branch: K5a both ways), GNN-Edge-MLP1 (type-major branch; its
    `fused_src1` form with K14, with ENABLE_EMLP1_SRC_PASS set; and its
    `fused1` branch with K10, through a forced gate that hides the
    type-major view), GNN-Edge-MLP1 without the target state (ranked
    branch), GNN-Edge-MLP0 (FiLM kernels) and RGDCN (class defaults,
    25,000-node packs; fine-rank neighbour sums, K5a both ways) on the
    bundled QM9 data at their tuned configs for 1 epoch each, then
    `tf_gnn_samples_torch.test` evaluates each written checkpoint (each
    path's train step also profiled: the hand kernels' device time and the
    ten other device events with the most); the
    kernel launch counters, set to 0 before each run and read after it,
    must show that every layer of every batch went through its kernels
    (`expected_launches`) and through no other, K9 in its gather form
    (`rs.FORM_LAUNCHES`); K13, K15 and K16 run on no path, as in the JAX
    package;
 6. the cache phase (`cache_phase`): the main path, GNN-FiLM at its tuned
    config through the train CLI, with its batches kept on the card
    (cache_batches_on_device, re-packed every 2 epochs) and a full
    training state written every 2 epochs, for 4 epochs: TRAIN packed at
    epochs 1 and 3 only, VALIDATION at epoch 1 only, every epoch through
    each cached batch once and through exactly the kernels
    `expected_launches` gives for its batches, finite losses; then a
    fresh model resumed from the epoch-2 state (its weights, optimizer
    slots and step equal to the file's bit for bit) runs epochs 3-4; and
    epoch 2's train and valid graphs/s cached, uncached, and uncached
    with the prefetch thread's packing done inline;
 7. the PPI phase (`task_phase`): synthetic PPI data of the published
    per-graph size (tf_gnn_samples_torch/tools/synthetic_data.py: graphs
    of 1,700-3,099 nodes, 28 forward edges a node, 50 features, 121
    labels), the train fold cut to 4 graphs and the valid and test folds
    to 1 each; `tf_gnn_samples_torch.train` trains GNN-FiLM,
    GNN-Edge-MLP0, GNN-Edge-MLP1, RGAT, RGCN, GGNN and RGIN at their tuned
    PPI_<model>.json, unchanged, for 1 epoch each, and
    `tf_gnn_samples_torch.test` evaluates each checkpoint; every train and
    eval step launches exactly what `expected_launches` gives for the
    branch its own batch takes (`batch_branch`: the fold's batches take up
    to three shapes), the losses are finite and the test's micro-F1 line
    parses with run_ppi_benchs.py's regex; each path's step times,
    profiled hand kernels and peak device memory;
 8. the headline reading (`ppi_headline`): RGCN at PPI_RGCN.json on the
    whole synthetic 20 / 2 / 2 fold, batches kept on the card, 3 epochs,
    once with the gate as it is (dense adjacency matmuls) and once with
    "aggregation_strategy": "pallas" (K5a, K5b): the train edges/s of
    epochs 2-3 beside the reference's V100 figure, with the card's name
    and power limit;
 9. the citation phase (`task_phase`): synthetic Planetoid data at
    Pubmed's size (data_kind pubmed); GNN-FiLM and RGCN at their class
    defaults for 3 epochs, then the test CLI, checked as the PPI paths;
10. the VarMisuse phase (`varmisuse_phase`): synthetic VarMisuse program
    graphs of bench.py's size (tools/synthetic_data.py, seed 0: 150 / 20 /
    20 graphs of 1,600-2,599 nodes, the ten named edge types; 22 edge
    types, 23 with self loops); the seven VarMisuse_<model>.json at full
    width and depth for 2 epochs each through the train CLI (GNN-FiLM
    streaming its train fold through 4 spawned parse workers, the others
    holding it in memory), then the test CLI on graphs-test: every step
    held to its own batch's branch as the PPI paths, every batch on a
    kernel branch, the accuracy line parsed with run_varmisuse_benchs.py's
    regex; each path's step times, profiled hand kernels, peak memory and
    epoch-2 graphs/s, and K12b's share of GNN-Edge-MLP1's step;
11. the streaming loader's parse rate (4 workers against 0); the
    per-type scan (`scan_phase`): RGIN and GNN-Edge-MLP1 at their tuned
    configs and RGDCN at its class defaults on a 10,000-node batch, each
    at typed_edge_scan "scan" against "unroll" on the card (launching no
    hand kernel), a train step timed at "scan", "unroll" and "auto"; and
    K12a / K12b (`k12_varmisuse`) on GNN-Edge-MLP1's batch's 22 streamed
    slices, held to their plain versions and timed beside their bounds;
12. a reference check per path: loss and gradients of the full-width
    model on a small batch on the card (kernels) against the same model
    on the CPU (the kernels' plain versions): QM9 (a 600-node pack, the
    same gates forced), PPI (one 400-node graph of PPI's degree; RGCN
    also with "pallas"), Pubmed (the whole graph, 4 of the class
    defaults' 8 layers) and VarMisuse (4 small graphs, 22 or 23 edge
    types, 4 layers of each tuned config; RGCN and GGNN also with
    "pallas"; RGIN, GNN-Edge-MLP1 and RGDCN also at "scan").
Usage: python3 chip_smoke.py
"""

import collections
import contextlib
import ctypes
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

# The port's package beside this script (absent there, the import fails
# and the script prints no result).
from tf_gnn_samples_torch.tools.timing import (BF16_TENSOR_FLOPS, F32_FLOPS,
                                               HBM_BYTES_PER_S, bound_ms,
                                               cuda_ms, cuda_queued_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "data", "qm9")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
# The synthetic PPI and Planetoid data the PPI and citation phases make
# (tf_gnn_samples_torch/tools/synthetic_data.py); removed at the end.
DATA_OUT = os.path.join(OUT, "data")
# One epoch a QM9 path (the VarMisuse phase took the time of the
# second); everything else: QM9_<model>.json.
TUNED_OVERRIDES = {"max_epochs": 1}
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
    Path("RGDCN", "RGDCN", {}),
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
    "wseg": "tf_gnn_samples_tpu/ops/ranked_segment.py:284",
    "wseg_bwd": "tf_gnn_samples_tpu/ops/ranked_segment.py:309",
    "film_fwd_mask": "tf_gnn_samples_tpu/ops/ranked_segment.py:398",
    "masked_segsum": "tf_gnn_samples_tpu/ops/ranked_segment.py:468",
    # K16, the A/B variants of tools/ (tf_gnn_samples_torch/tools/), by
    # kernel body; no model path runs them
    "film_fwd_v3": "tools/film_fwd_ab.py:98",
    "film_fwd_v2a": "tools/film_fwd_ab.py:46",
    "film_fwd_v2b": "tools/film_fwd_ab.py:73",
    "film_dgb_v3": "tools/film_fwd_ab.py:162",
    "film_dgb_v4": "tools/film_fwd_ab.py:202",
    "rowgather_loop": "tools/rowgather_prof.py:62",
    "rowgather_loop8": "tools/rowgather_prof.py:92",
    "rowgather_take": "tools/rowgather_prof.py:124",
    "rowgather_onehot": "tools/rowgather_prof.py:152",
    # the earlier designs of K3 and K4 (tf_gnn_samples_torch/tools/
    # earlier_designs.py), the baselines of their redesign; no model path
    # runs them
    "film_src_bwd_walk": "tf_gnn_samples_tpu/ops/ranked_segment.py:493",
    "film_bwd_walk": "tf_gnn_samples_tpu/ops/ranked_segment.py:526",
    # the earlier designs of K12a and K9, the same; kernels-line rows of
    # their own
    "act_agg_walk": "tf_gnn_samples_tpu/ops/ranked_segment.py:855",
    "rgat_src_bwd_walk": "tf_gnn_samples_tpu/ops/ranked_segment.py:1985",
    # the earlier designs of K7a and K6a, the same
    "wseg_t_walk": "tf_gnn_samples_tpu/ops/ranked_segment.py:1314",
    "segsum_t_walk": "tf_gnn_samples_tpu/ops/ranked_segment.py:1280",
    # the earlier designs of K10a and K10b, the same
    "typed_dense_agg_scalar": "tf_gnn_samples_tpu/ops/ranked_segment.py:1084",
    "typed_dense_agg_bwd_scalar":
        "tf_gnn_samples_tpu/ops/ranked_segment.py:1108",
    # the earlier designs of K14, K15a and K15b, the same
    "emlp1_src_bwd_scalar": "tf_gnn_samples_tpu/ops/ranked_segment.py:2305",
    "film_fwd_mask_walk": "tf_gnn_samples_tpu/ops/ranked_segment.py:398",
    "masked_segsum_walk": "tf_gnn_samples_tpu/ops/ranked_segment.py:468",
}
# The CUDA source of each K16 kernel body, by its counter's prefix.
K16_SOURCES = {"film_fwd": "film_fwd_ab", "film_dgb": "film_dgb_ab",
               "rowgather": "rowgather"}
K16_KERNELS = tuple(k for k, v in REPLACES.items() if v.startswith("tools/"))


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


def hand_kernel_names():
    """The __global__ function names of the port's CUDA sources."""
    names = set()
    csrc = os.path.join(ROOT, "tf_gnn_samples_torch", "csrc")
    for fname in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, fname)) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", f.read()))
    return names


def hand_kernel_of(key, names):
    """The kernel of `names` that the profiler event named `key` ran (the
    name as a whole word: "void masked_segsum_kernel<0>(...)" is not
    segsum_kernel), else None."""
    m = re.search(r"(?<!\w)(%s)(?!\w)" % "|".join(sorted(names)), key)
    return m.group(1) if m else None


def device_profile(fn, torch, calls=3, top=10):
    """Device time per call of `fn` that the card spends in kernels and
    copies (torch.profiler: the self device time of every device event of
    `calls` calls, over `calls`), the part of it spent in each of the
    port's hand-written kernels, by __global__ name ({} where none ran),
    and the `top` other device events (PyTorch's kernels, copies and
    fills) with the most device time: [name cut to 100 characters,
    launches per call, ms per call]. The rest of a step's device-timeline
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
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    names = hand_kernel_names()
    by_kernel = collections.Counter()
    others = []
    for e in events:
        name = hand_kernel_of(e.key, names)
        if name is not None:
            by_kernel[name] += e.self_device_time_total / 1e3 / calls
        else:
            others.append((e.key[:100], e.count / calls,
                           e.self_device_time_total / 1e3 / calls))
    others.sort(key=lambda x: -x[2])
    return busy_us / 1e3 / calls, dict(by_kernel), others[:top]


def device_busy_ms(fn, torch, calls=3) -> float:
    """device_profile's busy time alone."""
    return device_profile(fn, torch, calls)[0]


def first_batch(max_nodes: int, fold_name: str, task_name="QM9", data=DATA,
                **task_params):
    """(task, first batch of a fold, unshuffled, at `max_nodes` per
    batch) of `task_name`'s data in `data` (default: the bundled QM9)."""
    from tf_gnn_samples_torch.tasks.base import DataFold
    from tf_gnn_samples_torch.utils.registry import name_to_task_class

    cls, extra = name_to_task_class(task_name)
    task = cls({**cls.default_params(), **extra, **task_params})
    task.load_data(data)
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


def film_terms(torch, rs, msgs, table, ranks, act):
    """Per-edge bf16 terms of K1's function ([E, D], from a gamma|beta
    table) or of K2's ([E, 2D], from gamma|beta|g), rounded where the
    kernels round them."""
    d = msgs.shape[1]
    v = table.float().index_select(0, ranks)
    m = msgs.float()
    z = v[:, :d] * m + v[:, d:2 * d]
    if table.shape[1] == 2 * d:
        return rs._bf16_terms(rs._ACTS[act][0](z))
    dz = rs._ACTS[act][1](z) * v[:, 2 * d:]
    return torch.cat([rs._bf16_terms(m * dz), rs._bf16_terms(dz)], 1)


def src_terms(torch, rs, gcb, t, ranks, act):
    """K3's per-edge bf16 terms bf16(act'(gamma t[s_e] + beta) * C), f32
    [E, D], from its stream-form inputs."""
    d = t.shape[1]
    g = gcb.float()
    z = g[:, :d] * t.float().index_select(0, ranks) + g[:, d:2 * d]
    return rs._bf16_terms(rs._ACTS[act][1](z) * g[:, 2 * d:])


def row_counts(torch, rows, ranks):
    """f32 [rows]: the edges of each rank row."""
    return torch.zeros(rows, device=ranks.device).index_add_(
        0, ranks, torch.ones(ranks.shape[0], device=ranks.device))


def row_abs_sums(torch, rows, ranks, terms):
    """f32 [rows, C]: the sums of |terms| by rank row, for check_kernel."""
    return torch.zeros((rows, terms.shape[1]), device=terms.device
                       ).index_add_(0, ranks, terms.abs())


def check_exact(name, got, want, torch):
    """got must equal want bit for bit (same shape and type)."""
    max_err = (float((got.double() - want.double()).abs().max())
               if got.shape == want.shape and got.numel() else 0.0)
    print("  %s: max |kernel - plain| = %.3e (must be 0)" % (name, max_err))
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.equal(got, want)):
        raise AssertionError("%s disagrees with its plain version" % name)
    return max_err


def head_dw_check(name, dw, dw_want, msgs, g_e, torch):
    """A per-head weight cotangent d_w [E, K] (K7b, K8 and K13b; pass
    K7b's and K8's [K, E] transposed): each entry an f32 sum of the D / K
    exact products msgs[e, c] * g_e[e, c] of its head's columns, in
    another order than the plain version's, so within check_kernel's order
    bound with n = D / K."""
    e, k = dw.shape
    sums = (msgs.float() * g_e.float()).abs().reshape(e, k, -1).sum(-1)
    return check_kernel(
        name, dw.reshape(-1, 1), dw_want.reshape(-1, 1), sums.reshape(-1, 1),
        torch.full((e * k,), float(msgs.shape[1] // k), device=dw.device),
        torch)


def masked_terms(torch, rs, mask, c_e, leak):
    """K15b's per-edge terms bf16(C_e * factor(mask_e)), f32 [E, D] (its
    plain version with every edge a rank of its own)."""
    e = c_e.shape[0]
    return rs._masked_segsum_plain(mask, c_e,
                                   torch.arange(e, device=c_e.device), e, leak)


def chunk_span(torch, ranks, rows, edges=64):
    """[rows] int64: for each rank row, the index of the last block of
    `edges` consecutive edges (default a CHUNK) of the stream that holds
    one of its edges less that of the first (negative for a row without
    edges)."""
    block = torch.div(torch.arange(ranks.shape[0], device=ranks.device),
                      edges, rounding_mode="floor")
    first = torch.full((rows,), 2 ** 62, dtype=torch.int64,
                       device=ranks.device).scatter_reduce_(
                           0, ranks.long(), block, "amin")
    last = torch.full((rows,), -1, dtype=torch.int64,
                      device=ranks.device).scatter_reduce_(
                          0, ranks.long(), block, "amax")
    return last - first


def seam_rows(torch, ranks, rows):
    """[rows] bool: the rank rows whose edges span three or more CHUNK-edge
    blocks of the sorted-rank walk (film_common.cuh). Three or more
    partial sums reach such a row by atomicAdd in an order that changes
    from run to run; any other row is summed in a fixed order."""
    return chunk_span(torch, ranks, rows) >= 2


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


def rgat_side_inputs(torch, rs, gen, fine_key, rsrc, rpad, d, heads):
    """K9's inputs at width `d` with `heads` heads, as the fused RGAT
    backward builds them: a random bf16 [RPAD, D+3K] side table
    (cotangent | target logits | a positive denominator | correction),
    the [E, D+3K] stream its stream form reads (rs._side_rows: each edge's
    row at its fine key) and a random bf16 [R_src, D+K] t | lsrc table."""
    dev = fine_key.device
    side = torch.randn((rpad, d + 3 * heads), generator=gen, device=dev)
    side[:, d + heads:d + 2 * heads] = 0.5 + 4 * torch.rand(
        (rpad, heads), generator=gen, device=dev)
    side = side.to(torch.bfloat16)
    t_ext = torch.randn((rsrc, d + heads), generator=gen, device=dev).to(
        torch.bfloat16)
    return side, rs._side_rows(side, fine_key), t_ext


def rgat_src_bwd_bytes(torch, fine_key, ranks, rpad, rsrc, d, heads):
    """Bytes K9 must move in its gather form (each used side row once, a
    key and a rank an edge) and in its stream form (a row and a rank an
    edge); both read a t | lsrc row per source group and write the
    table."""
    e = ranks.shape[0]
    used = int(torch.unique(fine_key[(fine_key >= 0)
                                     & (fine_key < rpad)]).numel())
    groups = int(ranks[-1]) + 1 if e else 0
    common = groups * (d + heads) * 2 + rsrc * (d + heads) * 4
    return (used * (d + 3 * heads) * 2 + e * 8 + common,
            e * (d + 3 * heads) * 2 + e * 4 + common)


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


# The checks of K10's and K14's earlier bodies (typed_dense_agg_scalar,
# typed_dense_agg_bwd_scalar, emlp1_src_bwd_scalar) compute each edge's
# terms as the kernel does: its typed products in its own order
# (kernel_order_products), and its activations, their derivatives and the
# bf16 roundings by the plain version's f32 expressions, which the kernels evaluate in the same
# operation order (film_common.cuh; K11a and K12b are held to them
# exactly). The plain version sums the products in another order
# (torch.matmul), which can round a y, and so a dz or da, or a dx to the
# neighbouring bf16 number. So a kernel's output may differ from the plain
# version's by no more than the same math in the kernel's order does:
# entry by entry that is 0 for all but the few entries the two orders
# round apart, and a dropped, doubled or misplaced term of any product
# shows at once (tests/test_torch_chip_checks.py plants such faults). A
# kernel that changes its order of the products changes
# kernel_order_products with it. K10a, K10b and K14 sum their products on
# the tensor cores, in an order of their own: they are held by an
# order-free bound instead (typed_dense_agg_tc_check,
# typed_dense_agg_bwd_tc_check, emlp1_src_bwd_tc_check); K14's earlier
# body (emlp1_src_bwd_scalar) keeps the kernel-order one.


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


# K10a and K10b form their typed products on the tensor cores
# (csrc/typed_mma.cuh), which add each k-step's 16 exact bf16 products to
# the f32 accumulator aligned to the largest addend and truncate the bits
# shifted out, in an order of their own: an error below one f32 ulp
# (2^-23) of the largest addend per addend and per normalisation. Their
# checks take twice that, TC_UNIT = 2^-22 per term, and no order: an n-long
# product sum lies within gamma_n = n TC_UNIT / (1 - n TC_UNIT) of
# sum |a_k b_k| of its exact value, y computed in f64 here. An elementwise
# function of y (the activation, its derivative) then lies in its range
# over y's interval, widened by ACT_F32_SLACK (1 + |y|) for its own f32
# evaluation, and a bf16 rounding of it between the roundings of that
# range's ends (rounding is monotone): the bf16 neighbours y's interval
# reaches. Within [y - b, y + b] a function is monotone between the points
# of ACT_EXTREMA / DACT_EXTREMA, where its range's ends are taken too.
TC_UNIT = 2.0 ** -22
ACT_F32_SLACK = 2.0 ** -19
ACT_EXTREMA = {"gelu": (-0.7517915,)}
DACT_EXTREMA = {"gelu": (-math.sqrt(2.0), math.sqrt(2.0)), "tanh": (0.0,)}


def tc_gamma(n):
    """gamma_n at the tensor cores' unit TC_UNIT."""
    return n * TC_UNIT / (1 - n * TC_UNIT)


def typed_products_f64(torch, a, w, types):
    """(y, s), f64 [E, D_out]: y[e] = a_e @ w[type_e] and s[e] = |a_e| @
    |w[type_e]|, exact but for f64 rounding; 0 for an edge whose type is
    not in [0, L)."""
    y = torch.zeros((a.shape[0], w.shape[2]), dtype=torch.float64,
                    device=a.device)
    s = torch.zeros_like(y)
    for l in range(w.shape[0]):
        sel = (types == l).nonzero(as_tuple=True)[0]
        if sel.numel():
            al, wl = a.index_select(0, sel).double(), w[l].double()
            y.index_copy_(0, sel, al @ wl)
            s.index_copy_(0, sel, al.abs() @ wl.abs())
    return y, s


def fn_range(torch, fn, extrema, lo, hi):
    """f64 (min, max) of the elementwise `fn` over [lo, hi], `fn` monotone
    between the points `extrema`, widened by its f32 evaluation's slack."""
    pts = [lo, hi] + [torch.minimum(torch.maximum(torch.full_like(lo, c), lo),
                                     hi) for c in extrema]
    vals = torch.stack([fn(p).double() for p in pts])
    slack = ACT_F32_SLACK * (1 + torch.maximum(lo.abs(), hi.abs()))
    return vals.min(0).values - slack, vals.max(0).values + slack


def bf16_of(torch, v):
    """The bf16 rounding of f64 values through f32 (as the kernels round
    an f32 value), as f64: monotone, so it maps an interval's ends to the
    ends of the roundings of every value inside."""
    return v.float().to(torch.bfloat16).double()


def typed_dz_interval(torch, rs, x, w, g16, types, ranks, act):
    """(lo, hi), f64 [E, D]: the bf16 values dz = bf16(act'(y) g[rank]) may
    take for y in its order-free interval; 0 for an edge of no type."""
    y, s = typed_products_f64(torch, x, w, types)
    b = tc_gamma(w.shape[1]) * s
    dlo, dhi = fn_range(torch, rs._ACTS[act][1], DACT_EXTREMA.get(act, ()),
                        y - b, y + b)
    g = g16.index_select(0, ranks).double()
    valid = ((types >= 0) & (types < w.shape[0]))[:, None]
    lo = torch.where(valid, bf16_of(torch, torch.minimum(dlo * g, dhi * g)),
                     0.0)
    hi = torch.where(valid, bf16_of(torch, torch.maximum(dlo * g, dhi * g)),
                     0.0)
    return lo, hi


def outside(torch, got, lo, hi):
    """Entries of `got` outside [lo, hi] (elementwise), and whether all are
    finite."""
    v = got.double()
    return int(((v < lo) | (v > hi)).sum()), bool(torch.isfinite(v).all())


def typed_dense_agg_tc_check(torch, rs, got, want, x, w, types, ranks, rows,
                             act):
    """K10a's table (`got`) and the plain version's (`want`) on the same
    inputs, each within the order-free bound: every term bf16(act(y_e))
    one of the bf16 values y's interval reaches, [t_lo, t_hi], and the
    table row the f32 sum of its n terms, in any order (chunk partials,
    atomics): within sum t_lo - B and sum t_hi + B, B = 2 gamma_{n-1}
    sum max|t| + n FLT_MIN (2^-24 units, as check_kernel). The two tables
    cannot be held equal: they sum their products in other orders. Returns
    max |kernel - plain|."""
    y, s = typed_products_f64(torch, x, w, types)
    b = tc_gamma(w.shape[1]) * s
    flo, fhi = fn_range(torch, rs._ACTS[act][0], ACT_EXTREMA.get(act, ()),
                        y - b, y + b)
    valid = ((types >= 0) & (types < w.shape[0]))[:, None]
    tlo = torch.where(valid, bf16_of(torch, flo), 0.0)
    thi = torch.where(valid, bf16_of(torch, fhi), 0.0)
    counts = row_counts(torch, rows, ranks).double()[:, None]
    g = (counts - 1).clamp(min=0) * 2.0 ** -24
    order = (2 * g / (1 - g) * per_row(torch, rows, ranks,
                                       torch.maximum(tlo.abs(), thi.abs()))
             + counts * 2.0 ** -126)
    lo = per_row(torch, rows, ranks, tlo) - order
    hi = per_row(torch, rows, ranks, thi) + order
    bad, finite = outside(torch, got, lo, hi)
    bad_plain, _ = outside(torch, want, lo, hi)
    err = float((got.double() - want.double()).abs().max())
    print("  typed_dense_agg: max |kernel - plain| = %.3e; entries outside "
          "the order-free bound (unit 2^-22): kernel %d, plain %d; entries "
          "whose terms may round two ways: %d of %d"
          % (err, bad, bad_plain, int((tlo != thi).sum()), tlo.numel()))
    if bad or bad_plain or not finite:
        raise AssertionError("typed_dense_agg disagrees with its plain "
                             "version")
    return err


def typed_dense_agg_bwd_tc_check(torch, rs, got, want, x, w, g16, types,
                                 ranks, act):
    """K10b's (dx, dW) (`got`) and the plain version's (`want`) on the same
    inputs, within the order-free bound: dz one of the bf16 values
    [z_lo, z_hi] that y's interval reaches (typed_dz_interval); dx =
    bf16(dz W^T) summed over D in any order, so between the bf16 roundings
    of mid W^T -+ (half |W|^T + gamma_D max|z| |W|^T), mid and half the
    centre and half-width of the dz interval (0 for an edge of no type).
    dW[l] sums the type's n exact products x * dz in f32 (the tensor cores
    within blocks, atomics across them), in another order on every run:
    elementwise within |x_l|^T half + gamma_n |x_l|^T max|z| (+ n FLT_MIN)
    of x_l^T mid, a guard only at n near 10^5; and per type by norm,
    |dW - dW_plain| <= 1e-4 |dW_plain| + | |x_l|^T (z_hi - z_lo) |: both
    dz lie in the interval, and f32 rounding of n-term sums grows about as
    sqrt(n) u. Returns the larger max |kernel - plain|."""
    (dx, dw), (dx_want, dw_want) = got, want
    zlo, zhi = typed_dz_interval(torch, rs, x, w, g16, types, ranks, act)
    mid, half = (zlo + zhi) / 2, (zhi - zlo) / 2
    zmax = torch.maximum(zlo.abs(), zhi.abs())
    valid = ((types >= 0) & (types < w.shape[0]))[:, None]
    wt = w.transpose(1, 2)
    dxm, _ = typed_products_f64(torch, mid, wt, types)
    dxh, _ = typed_products_f64(torch, half, wt.abs(), types)
    _, dxs = typed_products_f64(torch, zmax, wt, types)
    reach = dxh + tc_gamma(w.shape[2]) * dxs
    dlo = torch.where(valid, bf16_of(torch, dxm - reach), 0.0)
    dhi = torch.where(valid, bf16_of(torch, dxm + reach), 0.0)
    bad, finite = outside(torch, dx, dlo, dhi)
    bad_plain, _ = outside(torch, dx_want, dlo, dhi)
    bad_w, worst_norm = 0, 0.0
    for l in range(w.shape[0]):
        sel = (types == l).nonzero(as_tuple=True)[0]
        n = sel.numel()
        xl = x.index_select(0, sel).double()
        ref = xl.t() @ mid.index_select(0, sel)
        allowed = (xl.abs().t() @ half.index_select(0, sel)
                   + tc_gamma(n) * (xl.abs().t() @ zmax.index_select(0, sel))
                   + n * 2.0 ** -126)
        for got_w in (dw[l], dw_want[l]):
            bad_w += int(((got_w.double() - ref).abs() > allowed).sum())
        spread = float(torch.linalg.norm(
            xl.abs().t() @ (zhi - zlo).index_select(0, sel)))
        want_norm = float(torch.linalg.norm(dw_want[l].double()))
        diff = float(torch.linalg.norm(dw[l].double() - dw_want[l].double()))
        if diff > 1e-4 * want_norm + spread:
            bad_w += 1
        worst_norm = max(worst_norm, diff / max(want_norm, 1e-30))
    err_x = float((dx.double() - dx_want.double()).abs().max())
    err_w = float((dw.double() - dw_want.double()).abs().max())
    print("  typed_dense_agg_bwd: max |kernel - plain| = %.3e (dx; entries "
          "outside the order-free bound: kernel %d, plain %d; dz entries "
          "that may round two ways: %d of %d), %.3e (dW; |dW - dW_plain| / "
          "|dW_plain| <= %.3e per type); dW entries and types over the "
          "bound: %d" % (err_x, bad, bad_plain, int((zlo != zhi).sum()),
                         zlo.numel(), err_w, worst_norm, bad_w))
    if (bad or bad_plain or bad_w or not finite
            or not bool(torch.isfinite(dw).all())):
        raise AssertionError("typed_dense_agg_bwd disagrees with its plain "
                             "version")
    return max(err_x, err_w)


def emlp1_src_bwd_intervals(torch, rs, gcb, t, cols, w, e_real, ranks,
                            act):
    """The order-free chained intervals of K14's per-edge values, as K10b's
    check takes them, f64 [E, D] each: with x = elu(m + beta) as the
    kernel and the plain version compute it, da one of the bf16 values
    [z_lo, z_hi] that y = bf16(x) W[l]'s interval reaches
    (typed_dz_interval, fed the edge's own g); dx = da W[l]^T, kept in
    f32, within mid W^T -+ (half |W|^T + gamma_D max|z| |W|^T) (mid, half
    the centre and half-width of the da interval); the term bf16(elu'(x)
    dx) (elu' >= 0) between the bf16 roundings of elu'(x) times that
    interval's ends, [t_lo, t_hi]. An edge at or past e_real or of no type
    in [0, L) has all four 0. Returns (z_lo, z_hi, t_lo, t_hi)."""
    e, d = ranks.shape[0], t.shape[1]
    g = gcb.float()
    x = rs._elu(t.index_select(0, ranks).float() + g[:, :d])
    c = cols.index_select(0, ranks.long())
    live = torch.arange(e, device=c.device) < e_real.to(c.device)
    types = torch.where(live, c, -1)
    every = torch.arange(e, device=c.device)
    zlo, zhi = typed_dz_interval(torch, rs, x.to(torch.bfloat16), w,
                                 gcb[:, d:], types, every, act)
    mid, half = (zlo + zhi) / 2, (zhi - zlo) / 2
    zmax = torch.maximum(zlo.abs(), zhi.abs())
    wt = w.transpose(1, 2)
    dxm, _ = typed_products_f64(torch, mid, wt, types)
    dxh, _ = typed_products_f64(torch, half, wt.abs(), types)
    _, dxs = typed_products_f64(torch, zmax, wt, types)
    reach = dxh + tc_gamma(d) * dxs
    de = rs._ACTS_FROM_OUT["elu"](x).double()
    valid = ((types >= 0) & (types < w.shape[0]))[:, None]
    tlo = torch.where(valid, bf16_of(torch, de * (dxm - reach)), 0.0)
    thi = torch.where(valid, bf16_of(torch, de * (dxm + reach)), 0.0)
    return zlo, zhi, tlo, thi


def spec_bound_ms(spec):
    """(bytes ms, operations ms) of a kernel spec: its bytes at the HBM
    rate; its elementwise work at the f32 rate and its typed products
    (K10, K14) at the bf16 tensor-core rate, the least time they could
    take. Its bound is the larger."""
    return (spec["nbytes"] / HBM_BYTES_PER_S * 1e3,
            max(spec["nops"] / F32_FLOPS,
                spec.get("tensor_ops", 0) / BF16_TENSOR_FLOPS) * 1e3)


def emlp1_src_bwd_fits_check(rs):
    """K14's gate (ops/ranked_segment.py emlp1_src_bwd_fits, a copy of the
    kernel's shared-memory layout that runs where nothing is built) and
    the kernel's own answer (csrc/emlp1_src_bwd.cu emlp1_src_bwd_fits)
    agree on every width up to 320 at 0 to 9 types."""
    from tf_gnn_samples_torch.ops import cuda_build

    fits = cuda_build.load("emlp1_src_bwd").emlp1_src_bwd_fits
    fits.argtypes, fits.restype = [ctypes.c_int] * 2, ctypes.c_int
    differ = [(l_eff, d) for l_eff in range(10) for d in range(1, 321)
              if bool(fits(d, l_eff)) != rs.emlp1_src_bwd_fits(l_eff, d)]
    if differ:
        raise AssertionError("emlp1_src_bwd_fits: the kernel and the gate "
                             "differ at (types, width) %s" % differ[:8])
    print("  emlp1_src_bwd_fits: the gate agrees with the kernel on 3,200 "
          "(types, width) pairs")


def emlp1_src_bwd_tc_check(torch, rs, got, want, gcb, t, cols, w, e_real,
                           ranks, rows, act):
    """K14's src-rank table (`got`) and the plain version's (`want`) on the
    same inputs, each within the order-free chained bound: every term in
    its interval [t_lo, t_hi] (emlp1_src_bwd_intervals), so each table
    row within the f32 sums of its terms' lower and upper ends, -+ B = 2
    gamma_{n-1} sum max|t| + n FLT_MIN (2^-24 units, as check_kernel),
    whatever order the sums take. Prints how many da and terms may round
    two ways and how wide the bound is against the row's sum of |term|.
    Returns max |kernel - plain|."""
    zlo, zhi, tlo, thi = emlp1_src_bwd_intervals(torch, rs, gcb, t, cols, w,
                                                 e_real, ranks, act)
    counts = row_counts(torch, rows, ranks).double()[:, None]
    gam = (counts - 1).clamp(min=0) * 2.0 ** -24
    tmax = per_row(torch, rows, ranks, torch.maximum(tlo.abs(), thi.abs()))
    order = 2 * gam / (1 - gam) * tmax + counts * 2.0 ** -126
    lo = per_row(torch, rows, ranks, tlo) - order
    hi = per_row(torch, rows, ranks, thi) + order
    bad, finite = outside(torch, got, lo, hi)
    bad_plain, _ = outside(torch, want, lo, hi)
    err = float((got.double() - want.double()).abs().max())
    width = ((hi - lo) / tmax)[tmax > 0]
    print("  emlp1_src_bwd: max |kernel - plain| = %.3e; entries outside the "
          "order-free bound (unit 2^-22): kernel %d, plain %d; da entries "
          "that may round two ways: %d, terms: %d, of %d; bound width / row "
          "sum of |term|: median %.3e, max %.3e"
          % (err, bad, bad_plain, int((zlo != zhi).sum()),
             int((tlo != thi).sum()), tlo.numel(),
             float(width.median()) if width.numel() else 0.0,
             float(width.max()) if width.numel() else 0.0))
    if bad or bad_plain or not finite:
        raise AssertionError("emlp1_src_bwd disagrees with its plain version")
    return err


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
    from tf_gnn_samples_torch.tools import earlier_designs, film_fwd_ab

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

    def order_check(name, n, ranks, terms):
        return lambda got, want: check_kernel(
            name, got, want, row_abs_sums(torch, n, ranks, terms),
            row_counts(torch, n, ranks), torch)

    def exact_check(name):
        return lambda got, want: check_exact(name, got, want, torch)

    def index_add(n, ranks, terms):
        return lambda: torch.zeros((n, terms.shape[1]), device=dev).index_add_(
            0, ranks, terms)

    def dw_check(name, stream):
        """d_w_t [K, E] is an f32 sum of D / K exact products (the first D
        columns of `stream` times the receiver's cotangent row) in another
        order than the plain version's."""
        return lambda dw, dw_want: head_dw_check(
            name, dw.t(), dw_want.t(), stream[:, :d], g7.index_select(0, rcv),
            torch)

    def wseg_bwd_check(got, want):
        """K7b: d_msgs must equal the plain version's."""
        (dm, dw), (dm_want, dw_want) = got, want
        err_m = exact_check("wseg_t_bwd d_msgs")(dm.float(), dm_want.float())
        return max(err_m, dw_check("wseg_t_bwd d_w_t", m7)(dw, dw_want))

    def wseg_rows_bwd_check(got, want):
        """K13b: d_msgs must equal the plain version's; d_w as K7b's."""
        (dm, dw), (dm_want, dw_want) = got, want
        err_m = check_exact("wseg_bwd d_msgs", dm, dm_want, torch)
        return max(err_m, head_dw_check("wseg_bwd d_w", dw, dw_want, m13,
                                        g7.index_select(0, rcv), torch))

    def k15a_check(act_m):
        """K15a (film_fwd_mask_check): the mask bit for bit, the table
        equal to K1's on the same inputs on every row that is not a seam
        row and within the order bound of the plain version's."""
        return lambda got, want: film_fwd_mask_check(
            torch, rs, got, want, rs._film_fwd_impl(msgs, gb, fine, act=act_m),
            msgs, gb, fine, act_m)

    def film_bwd_check(got, want):
        """K4: d_msgs must equal the plain version's; d_gb as K2."""
        (dm, dgb), (dm_want, dgb_want) = got, want
        err_m = exact_check("film_bwd d_msgs")(dm.float(), dm_want.float())
        return max(err_m, order_check("film_bwd d_gb", rpad, fine, k2_terms)(
            dgb, dgb_want))

    msgs, gb, gbg = randn(e, d), randn(rpad, 2 * d), randn(rpad, 3 * d)
    # K2 as the fused FiLM backward calls it: gamma|beta and g apart.
    gb2, g2 = gbg[:, :2 * d].contiguous(), gbg[:, 2 * d:].contiguous()
    # K3 as the fused FiLM backward calls it (its gather form): K2's
    # gamma|beta and g tables, read at each src-sorted edge's fine rank,
    # and the [L * n_pad, D] node table t, read at each src group's row;
    # its stream form and its earlier design read the [E, 3D] stream and
    # the t rows that the gather form spares the caller.
    if flat.win_sd:
        raise AssertionError("the QM9 src stream diluted")
    fine_src, t_index = flat.fine_rank_by_src, flat.src_from_rank
    t_rows = graph.num_edge_types * graph.n_pad
    t16 = randn(t_rows, d)
    gcb, t = rs._src_stream_inputs(gb2, g2, fine_src, t16, t_index)
    used_fine = int(torch.unique(fine_src[fine_src < rpad]).numel())
    # K3's gather form reads the used fine rows of gamma|beta|g, two ranks
    # an edge, a rank and a t row per src group and writes the table; its
    # stream form reads a gamma|beta|C row and a rank an edge instead.
    k3_bytes = (used_fine * 6 * d + e * 8 + n_src * (2 * d + 4)
                + rsrc * 4 * d)
    k3_stream_bytes = e * 3 * d * 2 + e * 4 + n_src * d * 2 + rsrc * d * 4
    # Per-edge bf16 terms of each FiLM kernel (for the order bound and for
    # the index_add_ yardstick, which sums precomputed terms only).
    k1_terms = film_terms(torch, rs, msgs, gb, fine, act)
    k2_terms = film_terms(torch, rs, msgs, gbg, fine, act)
    k3_terms = src_terms(torch, rs, gcb, t, src, act)
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
    # gathered stream (K8 reads its first D columns); K9's [RPAD, D+3K]
    # side table, read at each src-sorted edge's fine key (its gather
    # form, as the backward calls it; its stream form and its earlier body
    # read the [E, D+3K] stream gathered from it), and the [R_src, D+K]
    # t | lsrc table; also at PPI's width, D 320 with 4 heads (rows that
    # are not 16-byte aligned), on the same stream.
    m8 = randn(e, d + heads)
    side9, gcb9, t9 = rgat_side_inputs(torch, rs, gen, fine_src, rsrc, rpad,
                                       d, heads)
    k9_abs, k9_counts, k9_slack = rgat_src_bwd_bounds(
        torch, rs, gcb9, t9, src, rsrc, heads)
    k9_terms = rs._rgat_src_bwd_plain(
        gcb9, t9.index_select(0, src), torch.arange(e, device=dev), e, heads,
        50.0)  # edge by edge, for the index_add_ yardstick
    k9_bytes, k9_stream_bytes = rgat_src_bwd_bytes(torch, fine_src, src, rpad,
                                                   rsrc, d, heads)
    k9_wide = {"D 128, 8 heads": (d, heads), "D 320, 4 heads": (320, 4)}
    side9w, gcb9w, t9w = rgat_side_inputs(torch, rs, gen, fine_src, rsrc,
                                          rpad, 320, 4)
    k9_in = {"D 128, 8 heads": (side9, gcb9, t9),
             "D 320, 4 heads": (side9w, gcb9w, t9w)}

    def k9_form(form, v):
        side_v, gcb_v, t_v = k9_in[v]
        if form == "gather":
            return rs._rgat_src_bwd_gather_impl(
                side_v, fine_src, t_v, src, table_rows=rsrc,
                num_heads=k9_wide[v][1], clamp=50.0)
        if form == "stream":
            return rs._rgat_src_bwd_impl(gcb_v, t_v, src, table_rows=rsrc,
                                         num_heads=k9_wide[v][1], clamp=50.0)
        return earlier_designs.rgat_src_bwd_walk(
            gcb_v, t_v, src, table_rows=rsrc, num_heads=k9_wide[v][1],
            clamp=50.0)
    film_yardstick = ("torch.Tensor.index_add_ of the precomputed terms "
                      "(leaves out the row gathers, the modulation and the "
                      "activation)")
    # K11 / K12 inputs, as GNN-Edge-MLP1 builds them over the type-major
    # stream: bf16 streams, the f32 beta table and the bf16 table cotangent
    # over the (type, receiver) ranks; K11 runs elu, K12 gelu. K12a runs
    # once a layer over the four streamed types' slices: its spec times
    # that launch, `also` checks it on each slice alone and on the whole
    # stream and `extra` times those. K12b runs once per streamed type's
    # slice: its spec times the largest, `also` and `extra` the others and
    # the whole stream.
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
    table12 = torch.zeros((rpad, d), device=dev)  # K12a's timed table
    k12_terms = rs._bf16_terms(gelu(y12.float()))
    dgelu12 = dgelu(y12.float())
    # The K12a launches held against the earlier body and timed: one over
    # the layer's four streamed slices, one over each of them alone.
    k12a_parts = {"layer": [slices[l] for l in sorted(slices)]}
    k12a_parts.update({"type %d" % l: [slices[l]] for l in sorted(slices)})

    def k12a(label, parts):
        """The K12a spec of one launch over the stream slices `parts`
        ([(lo, hi)]) into a table of their rank rows: it reads the slices'
        messages and ranks and writes their rows of a table that the
        caller zeroed (the check runs on a table of its own; the timed
        call writes into one zeroed once, `out`); gelu through the erf
        polynomial is about 30 operations an element."""
        pieces = [(y12[lo:hi], tm[lo:hi]) for lo, hi in parts]
        idx = torch.cat([torch.arange(lo, hi, device=dev) for lo, hi in parts])
        ranks, terms = tm.index_select(0, idx), k12_terms.index_select(0, idx)
        el = int(idx.numel())
        n_l = sum(int(tm[hi - 1]) - int(tm[lo]) + 1 for lo, hi in parts)
        abs_l = row_abs_sums(torch, rpad, ranks, terms)
        counts_l = row_counts(torch, rpad, ranks)
        return dict(
            name="act_agg",
            kern=lambda: rs._act_agg_slices_impl(pieces, table_rows=rpad,
                                                 act="gelu"),
            timed=lambda: rs._act_agg_slices_impl(pieces, table_rows=rpad,
                                                  act="gelu", out=table12),
            plain=lambda: rs._act_agg_slices_plain(pieces, rpad, "gelu"),
            check=lambda got, want: check_kernel(
                "act_agg (%s)" % label, got, want, abs_l, counts_l, torch),
            nbytes=el * d * 2 + el * 4 + n_l * d * 4, nops=30 * el * d,
            yardstick=("torch.Tensor.index_add_ of the precomputed terms "
                       "(leaves out the activation)",
                       lambda: torch.zeros((rpad, d), device=dev).index_add_(
                           0, ranks, terms)))

    def k12a_walk(v, out=None):
        """K12a's earlier body on the slices of `v`, a launch a slice."""
        if out is None:
            out = torch.zeros((rpad, d), device=dev)
        for lo, hi in k12a_parts[v]:
            earlier_designs.act_agg_walk(y12[lo:hi], tm[lo:hi],
                                         table_rows=rpad, act="gelu", out=out)
        return out

    def k12(lo, hi):
        """K12b's spec on the stream slice [lo, hi)."""
        el = hi - lo
        msg, ranks = y12[lo:hi], tm[lo:hi]
        n_l = int(ranks[-1]) - int(ranks[0]) + 1
        dact_l = dgelu12[lo:hi]
        # K12b reads the messages, the ranks and the used rows of the bf16
        # cotangent table and writes [E_l, D] bf16; gelu' is about 45
        # operations an element.
        return dict(
            name="act_agg_bwd",
            kern=lambda: rs._act_agg_bwd_impl(msg, g12, ranks, act="gelu"),
            plain=lambda: rs._act_agg_bwd_plain(msg, g12, ranks, "gelu"),
            check=exact_check("act_agg_bwd [%d:%d]" % (lo, hi)),
            nbytes=2 * el * d * 2 + el * 4 + n_l * d * 2, nops=45 * el * d,
            yardstick=("index_select of the cotangent rows times the "
                       "precomputed derivative, rounded (three PyTorch "
                       "calls; leaves out gelu')",
                       lambda: (dact_l * g12.index_select(0, ranks).float()
                                ).to(torch.bfloat16)))

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
    # The kernel-order bound of K10a's earlier body (typed_dense_agg_scalar).
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
    # K14's work is that of its live edges (a streamed type's, before
    # e_real): the self-loop type's edges and the tail add nothing, so
    # their beta | g and t rows need not be read.
    live14 = ((cols14.index_select(0, src.long()) >= 0)
              & (torch.arange(e, device=dev) < e_real14))
    e14_live = int(live14.sum())
    n14_src_live = int(torch.unique_consecutive(src[live14]).numel())
    k14_abs, k14_counts, k14_slack = emlp1_src_bwd_bounds(
        torch, rs, gcb14, t14, cols14, w14, e_real14, src, rsrc, "gelu")
    k14_terms = rs._emlp1_src_bwd_plain(
        gcb14, t14.index_select(0, src), cols14.index_select(0, src.long()),
        w14, e_real14, torch.arange(e, device=dev), e, "gelu")

    # K13 inputs at RGAT's tuned coarse table (8 heads): the bf16 stream,
    # row-major [E, K] weights in [0, 1) and K7's bf16 table cotangent.
    m13 = randn(e, d)
    w13 = torch.rand((e, heads), generator=gen, device=dev)
    k13_terms = rs._bf16_terms(m13.float() * rs._head_replicate(w13.t(), d))
    # K15 inputs: K1's stream and table for K15a; for K15b the mask K15a
    # writes, brought into src-sorted order, and a bf16 C stream over the
    # src ranks (the dt pass of the masked FiLM backward).
    lanes = rs._mask_lanes(d)
    perm = flat.perm_by_src.long()
    mask15 = rs._film_fwd_mask_plain(msgs, gb, fine, "relu")[1].index_select(
        0, perm)
    c15 = randn(e, d)
    k15_terms = {leak: masked_terms(torch, rs, mask15, c15, leak)
                 for leak in (0.0, 0.2)}

    specs = [
        dict(name="film_fwd",
             kern=lambda: rs._film_fwd_impl(msgs, gb, fine, act=act),
             plain=lambda: rs._film_fwd_plain(msgs, gb, fine, act),
             check=order_check("film_fwd", rpad, fine, k1_terms),
             nbytes=e * d * 2 + e * 4 + n_fine * 2 * d * 2 + rpad * d * 4,
             nops=4 * e * d,
             yardstick=(film_yardstick, index_add(rpad, fine, k1_terms))),
        dict(name="film_bwd_dgb",
             kern=lambda: rs._film_bwd_dgb_split_impl(msgs, gb2, g2, fine,
                                                      act=act),
             plain=lambda: rs._film_bwd_dgb_plain(msgs, gbg, fine, act),
             check=order_check("film_bwd_dgb", rpad, fine, k2_terms),
             nbytes=e * d * 2 + e * 4 + n_fine * 3 * d * 2 + rpad * 2 * d * 4,
             nops=7 * e * d,
             yardstick=(film_yardstick, index_add(rpad, fine, k2_terms))),
        # K3 in its gather form; the gamma * g product and five operations
        # an element.
        dict(name="film_src_bwd",
             kern=lambda: rs._film_src_bwd_gather_impl(
                 gb2, g2, fine_src, t16, t_index, src, table_rows=rsrc,
                 act=act),
             plain=lambda: rs._film_src_bwd_gather_plain(
                 gb2, g2, fine_src, t16, t_index, src, rsrc, act),
             check=order_check("film_src_bwd", rsrc, src, k3_terms),
             nbytes=k3_bytes, nops=6 * e * d,
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
        # K4 is K2 plus the bf16 [E, D] message cotangent it writes; timed
        # in its split form, as the FiLM aggregation's backward calls it.
        dict(name="film_bwd",
             kern=lambda: rs._film_bwd_split_impl(msgs, gb2, g2, fine,
                                                  act=act),
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
        # K9 in its gather form reads the used rows of the [RPAD, D+3K]
        # side table, each edge's key and rank and the used rows of the
        # t | lsrc table and writes the [R_src, D+K] table; per column a
        # product for the head's dot, one for the term and two adds, per
        # head the softmax recompute.
        dict(name="rgat_src_bwd",
             kern=lambda: k9_form("gather", "D 128, 8 heads"),
             plain=lambda: rs._rgat_src_bwd_gather_plain(
                 side9, fine_src, t9, src, rsrc, heads, 50.0),
             check=lambda got, want: check_kernel(
                 "rgat_src_bwd (gather form)", got, want, k9_abs, k9_counts,
                 torch, term_ulps=1, slack=k9_slack),
             nbytes=k9_bytes, nops=5 * e * d + 16 * e * heads,
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
        k12a("layer", k12a_parts["layer"]),
        k12(*slices[big]),
        # K10a reads the bf16 stream, the types, the ranks and the weights
        # and writes the used table rows; per element of the output a
        # D-long product (on the tensor cores: 2 E D^2 bf16 operations)
        # and gelu. Held to the plain version by the order-free bound
        # (typed_dense_agg_tc_check).
        dict(name="typed_dense_agg",
             kern=lambda: rs._typed_dense_agg_impl(x10, w10, types,
                                                   rcv, table_rows=rows,
                                                   act="gelu"),
             plain=lambda: rs._typed_dense_agg_plain(x10, w10, types, rcv,
                                                     rows, "gelu"),
             check=lambda got, want: typed_dense_agg_tc_check(
                 torch, rs, got, want, x10, w10, types, rcv, rows, "gelu"),
             nbytes=(e * d * 2 + 2 * e * 4 + n_types * d * d * 2
                     + n_rcv * d * 4),
             nops=30 * e * d, tensor_ops=2 * e * d * d,
             yardstick=("a stable sort by type, one torch.matmul per type, "
                        "gelu and index_add_", k10a_other)),
        # K10b reads the stream, the types, the ranks, the weights and the
        # used rows of the bf16 cotangent table and writes dx (bf16) and
        # dW (f32); three D-long products per element (6 E D^2 bf16
        # operations on the tensor cores) and gelu'. Held by the
        # order-free bound (typed_dense_agg_bwd_tc_check).
        dict(name="typed_dense_agg_bwd",
             kern=lambda: rs._typed_dense_agg_bwd_impl(x10, w10, g10, types,
                                                       rcv, act="gelu"),
             plain=lambda: rs._typed_dense_agg_bwd_plain(x10, w10, g10,
                                                         types, rcv, "gelu"),
             check=lambda got, want: typed_dense_agg_bwd_tc_check(
                 torch, rs, got, want, x10, w10, g10, types, rcv, "gelu"),
             nbytes=(2 * e * d * 2 + 2 * e * 4 + n_rcv * d * 2
                     + n_types * d * d * (2 + 4)),
             nops=45 * e * d, tensor_ops=6 * e * d * d,
             yardstick=("the matching composition: a stable sort by type, "
                        "a row gather of the cotangent, three torch.matmul "
                        "per type, gelu' and index_copy_", k10b_other)),
        # K14 reads the beta | g rows of the live edges, the ranks, the
        # type column of the used src ranks, the t rows of the live ones
        # and the weights and writes the src-rank table; two D-long
        # products per element of a live edge (4 E_live D^2 bf16
        # operations on the tensor cores) and the elu / gelu' recompute.
        # Held to the plain version by the order-free chained bound
        # (emlp1_src_bwd_tc_check).
        dict(name="emlp1_src_bwd",
             kern=lambda: rs._emlp1_src_bwd_impl(
                 gcb14, t14, cols14, w14, e_real14, src, table_rows=rsrc,
                 act="gelu"),
             plain=lambda: rs._emlp1_src_bwd_plain(
                 gcb14, t14, cols14, w14, e_real14, src, rsrc, "gelu"),
             check=lambda got, want: emlp1_src_bwd_tc_check(
                 torch, rs, got, want, gcb14, t14, cols14, w14, e_real14,
                 src, rsrc, "gelu"),
             nbytes=(e14_live * 2 * d * 2 + e * 4 + n_src * 4
                     + n14_src_live * d * 2 + 4 * d * d * 2 + rsrc * d * 4),
             nops=60 * e14_live * d, tensor_ops=4 * e14_live * d * d,
             yardstick=("torch.Tensor.index_add_ of the precomputed terms "
                        "(leaves out the row gathers and the two typed "
                        "products per edge)", index_add(rsrc, src, k14_terms))),
    ]
    specs += [
        # K13a reads the bf16 stream, the [E, K] weights and the ranks and
        # writes the table; a multiply and an add per element.
        dict(name="wseg",
             kern=lambda: rs._wseg_impl(m13, w13, rcv, table_rows=rows,
                                        num_heads=heads),
             plain=lambda: rs._wseg_plain(m13, w13, rcv, rows),
             check=order_check("wseg", rows, rcv, k13_terms),
             nbytes=e * d * 2 + heads * e * 4 + e * 4 + rows * d * 4,
             nops=2 * e * d,
             yardstick=("torch.Tensor.index_add_ of the precomputed terms "
                        "(leaves out the head replicate and the product)",
                        index_add(rows, rcv, k13_terms))),
        # K13b reads the stream, the weights, the ranks and the used rows of
        # the bf16 cotangent table and writes d_msgs (bf16) and d_w; two
        # multiplies and an add per element. Its plain version is the
        # shortest composition.
        dict(name="wseg_bwd",
             kern=lambda: rs._wseg_bwd_impl(m13, w13, g7, rcv,
                                            num_heads=heads),
             plain=lambda: rs._wseg_bwd_plain(m13, w13, g7, rcv),
             check=wseg_rows_bwd_check,
             nbytes=(2 * e * d * 2 + 2 * heads * e * 4 + e * 4
                     + n_rcv * d * 2),
             nops=3 * e * d),
        # K15a is K1 (relu) plus the [E, lanes] f32 mask store; a compare
        # and a vote per element besides K1's work.
        dict(name="film_fwd_mask",
             kern=lambda: rs._film_fwd_mask_impl(msgs, gb, fine, act="relu"),
             plain=lambda: rs._film_fwd_mask_plain(msgs, gb, fine, "relu"),
             check=k15a_check("relu"),
             nbytes=(e * d * 2 + e * 4 + n_fine * 2 * d * 2 + rpad * d * 4
                     + e * lanes * 4),
             nops=6 * e * d,
             yardstick=("film_fwd (K1) on the same inputs, which writes no "
                        "mask", lambda: rs._film_fwd_impl(msgs, gb, fine,
                                                          act="relu"))),
        # K15b (relu) reads the mask's ceil(D/16) used lanes (the rest hold
        # 0 and are never read), the bf16 C stream and the src ranks, and
        # writes the src-rank table; a shift, a multiply and an add per
        # element.
        dict(name="masked_segsum",
             kern=lambda: rs._masked_segsum_impl(mask15, c15, src,
                                                 table_rows=rsrc, leak=0.0),
             plain=lambda: rs._masked_segsum_plain(mask15, c15, src, rsrc,
                                                   0.0),
             check=order_check("masked_segsum (relu)", rsrc, src,
                               k15_terms[0.0]),
             nbytes=(e * (-(-d // 16)) * 4 + e * d * 2 + e * 4
                     + rsrc * d * 4),
             nops=3 * e * d,
             yardstick=("torch.Tensor.index_add_ of the precomputed terms "
                        "(leaves out the mask unpack and the product)",
                        index_add(rsrc, src, k15_terms[0.0]))),
    ]
    # The RGAT path gives each K6 kernel two tables: K6a also sums the
    # target logits' cotangent over the fine ranks (shorter runs, more
    # seams per thread), K6b also expands the denominator over the
    # receiver ranks. These are checked only; the specs above are timed.
    table_rcv = torch.randn((heads, rows), generator=gen, device=dev)
    # K7a on the three streams RGAT gives it: the streamed branch's [E, D]
    # messages, the fused branch's [E, D+K] gather (K8's stream, read
    # through d_used) and that gather at PPI's D 320 with 4 heads, whose
    # 648-byte rows are not 16-byte aligned (the 2-byte path). Each is
    # (stream, weights, heads, d_used).
    k7_forms = {
        "streamed D 128, 8 heads": (m7, w_t, heads, d),
        "fused [E, D+K], D 128, 8 heads": (m8, w_t, heads, d),
        "fused [E, D+K], D 320, 4 heads": (
            randn(e, 320 + 4), torch.rand((4, e), generator=gen, device=dev),
            4, 320)}

    def k7a(which, v):
        """K7a (`which` "new") or its earlier body on the stream `v`."""
        stream, w_v, k_v, d_v = k7_forms[v]
        fn = (rs._wseg_t_impl if which == "new"
              else earlier_designs.wseg_t_walk)
        return fn(stream, w_v, rcv, table_rows=rows, num_heads=k_v,
                  d_used=d_v)

    # K6a on the two tables RGAT gives it: the softmax denominator over the
    # receiver ranks and the target logits' cotangent over the fine ranks.
    k6_tables = {"receiver table": (rcv, rows), "fine table": (fine, rpad)}
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
    # K12a on each streamed type's slice alone and K12b on the other
    # streamed types' slices, both over the whole stream (self-loop slice
    # included): checked, then timed into `extra`.
    extra = {"act_agg": {}, "act_agg_bwd": {}}
    whole = ("whole stream", [(0, e)])
    others = {"act_agg": [(v, p) for v, p in k12a_parts.items()
                          if v != "layer"] + [whole],
              "act_agg_bwd": [("type %d" % l, [rng_])
                              for l, rng_ in slices.items() if l != big]
              + [whole]}

    def k12_also(name):
        def run():
            worst = 0.0
            for label, parts in others[name]:
                spec = (k12a(label, parts) if name == "act_agg"
                        else k12(*parts[0]))
                got = spec["kern"]()
                torch.cuda.synchronize()
                worst = max(worst, spec["check"](got, spec["plain"]()))
                timed = spec.get("timed", spec["kern"])
                extra[spec["name"]][label] = {
                    "edges": sum(hi - lo for lo, hi in parts),
                    "ms": cuda_ms(timed),
                    "queued_ms": cuda_queued_ms(timed),
                    "plain_ms": cuda_ms(spec["plain"]),
                    "bound_ms": max(spec_bound_ms(spec))}
            return worst
        return run

    # K15a and K15b are timed with relu; leaky_relu is checked only.
    also["film_fwd_mask"] = lambda: k15a_check("leaky_relu")(
        rs._film_fwd_mask_impl(msgs, gb, fine, act="leaky_relu"),
        rs._film_fwd_mask_plain(msgs, gb, fine, "leaky_relu"))
    # K15b writes its whole table without a zero fill: for relu and
    # leaky_relu, raw launches into NaN tables; the torch.zeros of the same
    # table that its earlier wrapper ran is timed for the row.
    k15b_fill = {}

    def k15b_also():
        err = order_check(
            "masked_segsum (leaky_relu)", rsrc, src, k15_terms[0.2])(
                rs._masked_segsum_impl(mask15, c15, src, table_rows=rsrc,
                                       leak=0.2),
                rs._masked_segsum_plain(mask15, c15, src, rsrc, 0.2))
        for act_v, leak in rs.MASKABLE_ACTS.items():
            masked_segsum_table_check(
                torch, "masked_segsum (%s) into a NaN table" % act_v,
                masked_segsum_nan_tables(torch, rs, mask15, c15, src, rsrc,
                                         leak), src)
        zeros = lambda: torch.zeros((rsrc, d), device=dev)
        k15b_fill.update(zero_fill_ms=cuda_ms(zeros),
                         zero_fill_queued_ms=cuda_queued_ms(zeros))
        print("  torch.zeros of K15b's [%d, %d] f32 table: %.4f ms (%.4f "
              "queued)" % (rsrc, d, k15b_fill["zero_fill_ms"],
                           k15b_fill["zero_fill_queued_ms"]))
        # Its two kernels' device time, on the batch's ranks and with the
        # padded tail's one long run given a rank an edge (no row then
        # spans three chunks; timed only).
        tail = int((src == src[-1]).sum())
        split = src.clone()
        split[-tail:] += torch.arange(tail, device=dev, dtype=src.dtype)
        for label, rk in (("the batch's ranks", src),
                          ("its %d-edge padded run split" % tail, split)):
            by_kernel = device_profile(
                lambda: rs._masked_segsum_impl(mask15, c15, rk,
                                               table_rows=rsrc, leak=0.0),
                torch, calls=10)[1]
            print("  masked_segsum device ms by kernel (torch.profiler), %s: "
                  "%s" % (label, {k: round(v, 4) for k, v in
                                  sorted(by_kernel.items())}))
        return err

    also["masked_segsum"] = k15b_also
    also["act_agg"] = k12_also("act_agg")
    also["act_agg_bwd"] = k12_also("act_agg_bwd")
    # K2 through its gamma|beta|g form too (two views of one table).
    also["film_bwd_dgb"] = lambda: order_check(
        "film_bwd_dgb (one gamma|beta|g table)", rpad, fine, k2_terms)(
            rs._film_bwd_dgb_impl(msgs, gbg, fine, act=act),
            rs._film_bwd_dgb_plain(msgs, gbg, fine, act))
    # K3's stream form (the JAX package's inputs): within the order bound,
    # and equal to the gather form on every row that is not a seam row.
    def k3_stream_also():
        got = rs._film_src_bwd_impl(gcb, t, src, table_rows=rsrc, act=act)
        err = order_check("film_src_bwd (stream form)", rsrc, src, k3_terms)(
            got, rs._film_src_bwd_plain(gcb, t, src, rsrc, act))
        film_design_check(
            torch, "film_src_bwd gather form = stream form",
            rs._film_src_bwd_gather_impl(gb2, g2, fine_src, t16, t_index, src,
                                         table_rows=rsrc, act=act), got, src)
        print("  film_src_bwd (stream form): bound %.4f ms (%d bytes at 3.35 "
              "TB/s; the gather form's %d)"
              % (k3_stream_bytes / HBM_BYTES_PER_S * 1e3, k3_stream_bytes,
                 k3_bytes))
        return err

    def k4_also():
        """K4's gamma|beta|g form (two views of one table) against its split
        form, and its d_gb against K2's on the same inputs: the same terms
        in the same order."""
        split = rs._film_bwd_split_impl(msgs, gb2, g2, fine, act=act)
        film_bwd_design_check(torch, "film_bwd gamma|beta|g form = split "
                              "form", rs._film_bwd_impl(msgs, gbg, fine,
                                                        act=act), split, fine)
        film_design_check(torch, "film_bwd d_gb = film_bwd_dgb's", split[1],
                          rs._film_bwd_dgb_split_impl(msgs, gb2, g2, fine,
                                                      act=act), fine)
        return 0.0

    def k9_also():
        """K9's stream form within the order bound of its plain version and
        equal to the gather form on every row that is not a seam row, both
        forms at D 128 with 8 heads and at D 320 with 4 heads."""
        worst = 0.0
        for v, (d_v, k_v) in k9_wide.items():
            side_v, gcb_v, t_v = k9_in[v]
            abs_v, counts_v, slack_v = rgat_src_bwd_bounds(
                torch, rs, gcb_v, t_v, src, rsrc, k_v)
            want = rs._rgat_src_bwd_plain(gcb_v, t_v, src, rsrc, k_v, 50.0)
            got = {form: k9_form(form, v) for form in ("gather", "stream")}
            for form, out in got.items():
                worst = max(worst, check_kernel(
                    "rgat_src_bwd (%s form, %s)" % (form, v), out, want,
                    abs_v, counts_v, torch, term_ulps=1, slack=slack_v))
            film_design_check(torch, "rgat_src_bwd gather form = stream form "
                              "(%s)" % v, got["gather"], got["stream"], src)
        print("  rgat_src_bwd (stream form): bound %.4f ms (%d bytes at 3.35 "
              "TB/s; the gather form's %d)"
              % (k9_stream_bytes / HBM_BYTES_PER_S * 1e3, k9_stream_bytes,
                 k9_bytes))
        return worst

    also["film_src_bwd"] = k3_stream_also
    also["film_bwd"] = k4_also
    also["rgat_src_bwd"] = k9_also

    def k7_also():
        """K7a on the fused branch's streams (d_used < dim_in; at D 320 the
        2-byte path) within the order bound of its plain version."""
        worst = 0.0
        for v in list(k7_forms)[1:]:
            stream, w_v, _, d_v = k7_forms[v]
            terms = rs._bf16_terms(stream[:, :d_v].float()
                                   * rs._head_replicate(w_v, d_v))
            worst = max(worst, check_kernel(
                "wseg_t (%s)" % v, k7a("new", v),
                rs._wseg_t_plain(stream, w_v, rcv, rows, d_v),
                row_abs_sums(torch, rows, rcv, terms),
                row_counts(torch, rows, rcv), torch))
        return worst

    def k13_also():
        """K13a against K7a on the same stream and the same weights laid
        out head-major: one template walks both, so every row that is not
        a seam row is equal bit for bit."""
        film_design_check(
            torch, "wseg = wseg_t on the transposed weights",
            rs._wseg_impl(m13, w13, rcv, table_rows=rows, num_heads=heads),
            rs._wseg_t_impl(m13, w13.t().contiguous(), rcv, table_rows=rows,
                            num_heads=heads), rcv)
        return 0.0

    also["wseg_t"] = k7_also
    also["wseg"] = k13_also
    # Bounds of K9's forms and K12a's launches at the shapes timed against
    # their earlier bodies (the earlier bodies read the stream as the
    # stream form does; K12a's read what one launch over the same slices
    # reads).
    k9_bounds = {}
    for v, (d_v, k_v) in k9_wide.items():
        g_bytes, s_bytes = rgat_src_bwd_bytes(torch, fine_src, src, rpad,
                                              rsrc, d_v, k_v)
        ops = (5 * e * d_v + 16 * e * k_v) / F32_FLOPS
        g_ms, s_ms = (max(b / HBM_BYTES_PER_S, ops) * 1e3
                      for b in (g_bytes, s_bytes))
        k9_bounds[v] = {"new": g_ms, "other": s_ms, "earlier": s_ms}
    k12a_bounds = {}
    for v, parts in k12a_parts.items():
        spec = k12a(v, parts)
        b = max(spec["nbytes"] / HBM_BYTES_PER_S,
                spec["nops"] / F32_FLOPS) * 1e3
        k12a_bounds[v] = {"new": b, "earlier": b}
    k7a_bounds, k6a_bounds = {}, {}
    for v, (_, _, k_v, d_v) in k7_forms.items():
        b = max((e * d_v * 2 + k_v * e * 4 + e * 4 + rows * d_v * 4)
                / HBM_BYTES_PER_S, 2 * e * d_v / F32_FLOPS) * 1e3
        k7a_bounds[v] = {"new": b, "earlier": b}
    for v, (_, rows_v) in k6_tables.items():
        b = max((heads * e * 4 + e * 4 + heads * rows_v * 4)
                / HBM_BYTES_PER_S, heads * e / F32_FLOPS) * 1e3
        k6a_bounds[v] = {"new": b, "earlier": b}
    def spec_bounds(name, variants):
        """{v: {"new": b, "earlier": b}}: the bound of spec `name` (its
        redesign and earlier body do the same work) for each variant."""
        b = max(spec_bound_ms(next(sp for sp in specs
                                   if sp["name"] == name)))
        return {v: {"new": b, "earlier": b} for v in variants}

    k10_bounds = {name: spec_bounds(name, ("gelu",))
                  for name in ("typed_dense_agg", "typed_dense_agg_bwd")}

    def tc_design_check(new_check, earlier_check):
        """K10a's, K10b's or K14's redesign (`got`) against its earlier
        body (`earlier`), gelu: the two sum their typed products in other
        orders (the tensor cores' against the index order), so no entry
        need be equal; each is held to the plain version instead, the
        redesign by the order-free bound and the earlier body by the
        kernel-order one."""
        def check(torch, name, got, earlier, ranks):
            print("  %s, each against the plain version:" % name)
            new_check(got, "gelu")
            earlier_check(earlier, "gelu")
        return check

    def k10a_plain(act_v):
        return rs._typed_dense_agg_plain(x10, w10, types, rcv, rows, act_v)

    def k10b_plain(act_v):
        return rs._typed_dense_agg_bwd_plain(x10, w10, g10, types, rcv, act_v)

    def k10a_earlier_check(got, act_v):
        """K10a's earlier body within the kernel-order bound."""
        abs_v, counts_v, slack_v = typed_dense_agg_bounds(
            torch, rs, x10, w10, types, rcv, rows, act_v)
        return check_kernel("typed_dense_agg_scalar", got, k10a_plain(act_v),
                            abs_v, counts_v, torch, slack=slack_v)

    def k10b_earlier_check(got, act_v):
        """K10b's earlier body within the kernel-order bound."""
        return typed_dense_agg_bwd_check(torch, rs, got, k10b_plain(act_v),
                                         x10, w10, g10, types, rcv, act_v)

    def k14_plain(act_v):
        return rs._emlp1_src_bwd_plain(gcb14, t14, cols14, w14, e_real14, src,
                                       rsrc, act_v)

    def k14_earlier_check(got, act_v):
        """K14's earlier body within the kernel-order bound."""
        return check_kernel("emlp1_src_bwd_scalar", got, k14_plain(act_v),
                            k14_abs, k14_counts, torch, slack=k14_slack)

    k14_bounds = spec_bounds("emlp1_src_bwd", ("gelu",))
    k15a_bounds = spec_bounds("film_fwd_mask", ("relu", "leaky_relu"))
    k15b_bounds = spec_bounds("masked_segsum", tuple(rs.MASKABLE_ACTS))

    designs = {
        "film_fwd": lambda: earlier_design(
            torch, "film_fwd",
            lambda a: rs._film_fwd_impl(msgs, gb, fine, act=a),
            lambda a: film_fwd_ab._impl_v3(msgs, gb, fine, act=a, group=1),
            fine),
        "film_bwd_dgb": lambda: earlier_design(
            torch, "film_bwd_dgb",
            lambda a: rs._film_bwd_dgb_split_impl(msgs, gb2, g2, fine, act=a),
            lambda a: film_fwd_ab._impl_dgb_v3(msgs, gbg, fine, act=a,
                                               group=1),
            fine),
        # K3: the gather form and the stream form against the earlier body
        # on the stream.
        "film_src_bwd": lambda: earlier_design(
            torch, "film_src_bwd",
            lambda a: rs._film_src_bwd_gather_impl(
                gb2, g2, fine_src, t16, t_index, src, table_rows=rsrc, act=a),
            lambda a: earlier_designs.film_src_bwd_walk(
                gcb, t, src, table_rows=rsrc, act=a),
            src, other=lambda a: rs._film_src_bwd_impl(
                gcb, t, src, table_rows=rsrc, act=a)),
        "film_bwd": lambda: earlier_design(
            torch, "film_bwd",
            lambda a: rs._film_bwd_split_impl(msgs, gb2, g2, fine, act=a),
            lambda a: earlier_designs.film_bwd_walk(msgs, gbg, fine, act=a),
            fine, check=film_bwd_design_check),
        # K12a (gelu, as GNN-Edge-MLP1 runs it): one launch over the layer's
        # four slices against four launches of the earlier body, and one
        # launch over each slice against one; both timed into a table
        # zeroed once, as the spec is.
        "act_agg": lambda: earlier_design(
            torch, "act_agg",
            lambda v: rs._act_agg_slices_impl(
                [(y12[lo:hi], tm[lo:hi]) for lo, hi in k12a_parts[v]],
                table_rows=rpad, act="gelu"),
            k12a_walk,
            {v: [tm[lo:hi] for lo, hi in p] for v, p in k12a_parts.items()},
            check=slices_design_check, variants=tuple(k12a_parts),
            timed=lambda which, v: (
                (lambda: k12a_walk(v, table12)) if which == "earlier"
                else k12a(v, k12a_parts[v])["timed"]),
            bounds=k12a_bounds),
        # K9: the gather form and the stream form against the earlier body
        # on the stream, at D 128 with 8 heads and at D 320 with 4.
        "rgat_src_bwd": lambda: earlier_design(
            torch, "rgat_src_bwd", lambda v: k9_form("gather", v),
            lambda v: k9_form("walk", v), src,
            other=lambda v: k9_form("stream", v), variants=tuple(k9_wide),
            bounds=k9_bounds),
        # K7a on the streamed branch's stream, the fused branch's [E, D+K]
        # gather and that gather at D 320 with 4 heads.
        "wseg_t": lambda: earlier_design(
            torch, "wseg_t", lambda v: k7a("new", v),
            lambda v: k7a("earlier", v), rcv, variants=tuple(k7_forms),
            bounds=k7a_bounds),
        # K6a on its receiver and fine tables: equal on every row of at
        # most two 8-edge runs.
        "segsum_t": lambda: earlier_design(
            torch, "segsum_t",
            lambda v: rs._segsum_t_impl(m_t, k6_tables[v][0],
                                        table_rows=k6_tables[v][1]),
            lambda v: earlier_designs.segsum_t_walk(
                m_t, k6_tables[v][0], table_rows=k6_tables[v][1]),
            {v: t[0] for v, t in k6_tables.items()},
            check=segsum_t_design_check, variants=tuple(k6_tables),
            bounds=k6a_bounds),
        # K10a and K10b (gelu, as GNN-Edge-MLP1 runs them) against their
        # earlier bodies (scalar f32 products) on the fused1 branch's
        # inputs at the QM9 batch.
        "typed_dense_agg": lambda: earlier_design(
            torch, "typed_dense_agg",
            lambda a: rs._typed_dense_agg_impl(x10, w10, types, rcv,
                                               table_rows=rows, act=a),
            lambda a: earlier_designs.typed_dense_agg_scalar(
                x10, w10, types, rcv, table_rows=rows, act=a),
            rcv, variants=("gelu",),
            check=tc_design_check(
                lambda got, a: typed_dense_agg_tc_check(
                    torch, rs, got, k10a_plain(a), x10, w10, types, rcv, rows,
                    a), k10a_earlier_check),
            bounds=k10_bounds["typed_dense_agg"]),
        "typed_dense_agg_bwd": lambda: earlier_design(
            torch, "typed_dense_agg_bwd",
            lambda a: rs._typed_dense_agg_bwd_impl(x10, w10, g10, types, rcv,
                                                   act=a),
            lambda a: earlier_designs.typed_dense_agg_bwd_scalar(
                x10, w10, g10, types, rcv, act=a),
            rcv, variants=("gelu",),
            check=tc_design_check(
                lambda got, a: typed_dense_agg_bwd_tc_check(
                    torch, rs, got, k10b_plain(a), x10, w10, g10, types, rcv,
                    a), k10b_earlier_check),
            bounds=k10_bounds["typed_dense_agg_bwd"]),
        # K14 (gelu, as the fused_src1 backward runs it) against its
        # earlier body (scalar f32 products) on the branch's inputs at the
        # QM9 batch.
        "emlp1_src_bwd": lambda: earlier_design(
            torch, "emlp1_src_bwd",
            lambda a: rs._emlp1_src_bwd_impl(
                gcb14, t14, cols14, w14, e_real14, src, table_rows=rsrc,
                act=a),
            lambda a: earlier_designs.emlp1_src_bwd_scalar(
                gcb14, t14, cols14, w14, e_real14, src, table_rows=rsrc,
                act=a),
            src, variants=("gelu",),
            check=tc_design_check(
                lambda got, a: emlp1_src_bwd_tc_check(
                    torch, rs, got, k14_plain(a), gcb14, t14, cols14, w14,
                    e_real14, src, rsrc, a), k14_earlier_check),
            bounds=k14_bounds),
        # K15a against its earlier body (K1's earlier walk): the mask bit
        # for bit, the table on every row that is not a seam row; timed
        # with relu, leaky_relu too.
        "film_fwd_mask": lambda: earlier_design(
            torch, "film_fwd_mask",
            lambda a: rs._film_fwd_mask_impl(msgs, gb, fine, act=a),
            lambda a: earlier_designs.film_fwd_mask_walk(msgs, gb, fine,
                                                         act=a),
            fine, check=film_fwd_mask_design_check,
            variants=("relu", "leaky_relu"), bounds=k15a_bounds),
        # K15b against its earlier body (atomics into a zeroed table): equal
        # on every row of at most two chunks, within the order bound on
        # the rest; timed with relu, leaky_relu too. `ranks` carries each
        # variant's leak to the check.
        "masked_segsum": lambda: earlier_design(
            torch, "masked_segsum",
            lambda a: rs._masked_segsum_impl(
                mask15, c15, src, table_rows=rsrc,
                leak=rs.MASKABLE_ACTS[a]),
            lambda a: earlier_designs.masked_segsum_walk(
                mask15, c15, src, table_rows=rsrc,
                leak=rs.MASKABLE_ACTS[a]),
            {a: (src, leak) for a, leak in rs.MASKABLE_ACTS.items()},
            check=lambda torch_, name, got, earlier, rk:
                masked_segsum_design_check(torch_, rs, name, got, earlier,
                                           mask15, c15, *rk),
            variants=tuple(rs.MASKABLE_ACTS), bounds=k15b_bounds),
    }
    results = []
    for spec in specs:
        name = spec["name"]
        got = spec["kern"]()
        torch.cuda.synchronize()
        max_err = spec["check"](got, spec["plain"]())
        if name in also:
            max_err = max(max_err, also[name]())
        timed = spec.get("timed", spec["kern"])
        ms = cuda_ms(timed)
        plain_ms = cuda_ms(spec["plain"])
        bound_bytes_ms, bound_ops_ms = spec_bound_ms(spec)
        bound_ms = max(bound_bytes_ms, bound_ops_ms)
        row = {
            "name": name, "route": "cuda",
            "source": "tf_gnn_samples_torch/csrc/%s.cu" % name,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": None,
            "queued_ms": cuda_queued_ms(timed),
        }
        if name in designs:
            row["earlier_design"] = designs[name]()
        if name == "masked_segsum":
            row.update(k15b_fill)
        # The library call and the yardstick are timed both ways too, so
        # that each compares with the kernel's queued time like for like.
        if "library" in spec:
            what, fn = spec["library"]
            row["library_ms"] = cuda_ms(fn)
            row["library_queued_ms"] = cuda_queued_ms(fn)
            other = "library (%s) %.4f ms (%.4f queued)" % (
                what, row["library_ms"], row["library_queued_ms"])
        elif "yardstick" in spec:
            what, fn = spec["yardstick"]
            row["yardstick_ms"] = cuda_ms(fn)
            row["yardstick_queued_ms"] = cuda_queued_ms(fn)
            row["yardstick"] = what
            other = ("no single PyTorch call computes this function; "
                     "yardstick: %s %.4f ms (%.4f queued)"
                     % (what, row["yardstick_ms"], row["yardstick_queued_ms"]))
        else:
            other = "no single PyTorch call computes this function"
        # The bound's two terms, and for K10 and K14 what their typed
        # products take at the f32 rate (their earlier bodies form them
        # with scalar f32 multiplies and adds): computed, not measured, so
        # printed here and kept out of the kernels line.
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
        if name == "act_agg":
            # The row is one launch over the layer's four streamed slices,
            # as the main path launches it.
            row["edges"] = sum(hi - lo for lo, hi in k12a_parts["layer"])
            row["other_shapes"] = extra[name]
            print("  act_agg on its other shapes: %s" % json.dumps(extra[name]))
        elif name in extra:
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
    # The earlier bodies of K12a, K9, K7a, K6a, K10a, K10b, K14 and K15a,
    # rows of their own (no model path launches them): within the order
    # bound of the plain version, timed in turns with the redesign above
    # at the main path's shapes (K12a: the layer's four slices, a launch
    # each; K9: D 128, 8 heads, on the stream; K7a: the streamed branch's
    # stream; K6a: the receiver table; K10: the fused1 branch's inputs,
    # gelu; K14: the fused_src1 branch's, gelu; K15a: relu). The plain
    # version and the bound are their function's.
    layer = k12a("layer", k12a_parts["layer"])
    walks = {
        "act_agg_walk": ("act_agg", "layer", lambda: layer["check"](
            k12a_walk("layer"), layer["plain"]())),
        "rgat_src_bwd_walk": ("rgat_src_bwd", "D 128, 8 heads",
                              lambda: check_kernel(
                                  "rgat_src_bwd_walk",
                                  k9_form("walk", "D 128, 8 heads"),
                                  rs._rgat_src_bwd_plain(gcb9, t9, src, rsrc,
                                                         heads, 50.0),
                                  k9_abs, k9_counts, torch, term_ulps=1,
                                  slack=k9_slack)),
        "wseg_t_walk": ("wseg_t", "streamed D 128, 8 heads",
                        lambda: order_check("wseg_t_walk", rows, rcv,
                                            k7_terms)(
                            k7a("earlier", "streamed D 128, 8 heads"),
                            rs._wseg_t_plain(m7, w_t, rcv, rows))),
        "segsum_t_walk": ("segsum_t", "receiver table",
                          lambda: order_check(
                              "segsum_t_walk", rows, rcv,
                              rs._bf16_terms(m_t).t())(
                                  earlier_designs.segsum_t_walk(
                                      m_t, rcv, table_rows=rows).t(),
                                  rs._segsum_t_plain(m_t, rcv, rows).t())),
        "typed_dense_agg_scalar": (
            "typed_dense_agg", "gelu", lambda: k10a_earlier_check(
                earlier_designs.typed_dense_agg_scalar(
                    x10, w10, types, rcv, table_rows=rows, act="gelu"),
                "gelu")),
        "typed_dense_agg_bwd_scalar": (
            "typed_dense_agg_bwd", "gelu", lambda: k10b_earlier_check(
                earlier_designs.typed_dense_agg_bwd_scalar(
                    x10, w10, g10, types, rcv, act="gelu"), "gelu")),
        "emlp1_src_bwd_scalar": (
            "emlp1_src_bwd", "gelu", lambda: k14_earlier_check(
                earlier_designs.emlp1_src_bwd_scalar(
                    gcb14, t14, cols14, w14, e_real14, src, table_rows=rsrc,
                    act="gelu"), "gelu")),
        "film_fwd_mask_walk": (
            "film_fwd_mask", "relu", lambda: k15a_check("relu")(
                earlier_designs.film_fwd_mask_walk(msgs, gb, fine,
                                                   act="relu"),
                rs._film_fwd_mask_plain(msgs, gb, fine, "relu"))),
        "masked_segsum_walk": (
            "masked_segsum", "relu", lambda: order_check(
                "masked_segsum_walk", rsrc, src, k15_terms[0.0])(
                    earlier_designs.masked_segsum_walk(
                        mask15, c15, src, table_rows=rsrc, leak=0.0),
                    rs._masked_segsum_plain(mask15, c15, src, rsrc, 0.0)))}
    for name, (new_name, v, err) in walks.items():
        new_row = next(r for r in results if r["name"] == new_name)
        times = new_row["earlier_design"][v]
        bound = times.get("earlier_bound_ms", new_row["bound_ms"])
        results.append({
            "name": name, "route": "cuda",
            "source": "tf_gnn_samples_torch/csrc/%s.cu" % name,
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err(),
            "ms": times["earlier_ms"], "plain_ms": new_row["plain_ms"],
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "queued_ms": times["earlier_queued_ms"], "shape": v})
    return results, graph


def film_fwd_mask_check(torch, rs, got, want, k1, msgs, gb, ranks, act):
    """K15a's (table, mask) (`got`) against the plain version's (`want`)
    and K1's table (`k1`) on the same inputs: the mask bit for bit; the
    table equal to K1's on every row that is not a seam row (one walk, one
    sum order: film_design_check) and within the order bound of the plain
    version's everywhere. Returns max |kernel - plain| of the table."""
    (table, mask), (table_want, mask_want) = got, want
    rows = table.shape[0]
    film_design_check(torch, "film_fwd_mask (%s) table = film_fwd's" % act,
                      table, k1, ranks)
    check_exact("film_fwd_mask (%s) mask" % act, mask, mask_want, torch)
    terms = film_terms(torch, rs, msgs, gb, ranks, act)
    return check_kernel("film_fwd_mask (%s) table" % act, table, table_want,
                        row_abs_sums(torch, rows, ranks, terms),
                        row_counts(torch, rows, ranks), torch)


def film_fwd_mask_design_check(torch, name, got, earlier, ranks):
    """K15a's (table, mask) against its earlier body's on the same inputs:
    the mask bit for bit, the table as film_design_check (the same sums in
    the same order on every row that is not a seam row)."""
    (table, mask), (table_e, mask_e) = got, earlier
    check_exact("%s mask" % name, mask, mask_e, torch)
    return film_design_check(torch, "%s table" % name, table, table_e, ranks)


def masked_segsum_design_check(torch, rs, name, got, earlier, mask, c_e,
                               ranks, leak):
    """K15b (`got`) against its earlier body (`earlier`) on the same inputs.
    Both sum a row's terms per 64-edge chunk in stream order from 0; the
    earlier body adds a row's chunk partials by atomicAdd, the redesign in
    chunk order. So every row of at most two chunks (one or two partials)
    must be equal bit for bit (film_design_check), and every row of three
    or more within the order bound of the earlier body's. Returns max
    |got - earlier|."""
    rows = got.shape[0]
    err = film_design_check(torch, name, got, earlier, ranks)
    seams = seam_rows(torch, ranks, rows)
    if not bool(seams.any()):
        return err
    terms = masked_terms(torch, rs, mask, c_e, leak)
    return check_kernel(
        "%s on the %d rows of three or more chunks" % (name, int(seams.sum())),
        got[seams], earlier[seams],
        row_abs_sums(torch, rows, ranks, terms)[seams],
        row_counts(torch, rows, ranks)[seams], torch)


def masked_segsum_nan_tables(torch, rs, mask, c_e, ranks, rows, leak):
    """Two raw launches of K15b (rs._masked_segsum_call, no wrapper), each
    into a table pre-filled with NaN."""
    tables = []
    for _ in range(2):
        out = torch.full((rows, c_e.shape[1]), float("nan"),
                         device=c_e.device)
        rs._masked_segsum_call(mask, c_e, ranks, out, leak)
        tables.append(out)
    torch.cuda.synchronize()
    return tables


def masked_segsum_table_check(torch, name, tables, ranks):
    """K15b's tables of masked_segsum_nan_tables: every row must be written
    (no NaN left), the rows no edge reaches must be exactly 0, and the two
    launches must give the same bits (no atomics, one order on every
    run)."""
    first, again = tables
    rows = first.shape[0]
    unwritten = int(torch.isnan(first).any(1).sum())
    reached = row_counts(torch, rows, ranks) > 0
    nonzero = int((first[~reached] != 0).any(1).sum())
    print("  %s: %d of %d rows unwritten, %d of the %d rows no edge "
          "reaches not 0" % (name, unwritten, rows, nonzero,
                             int((~reached).sum())))
    if unwritten or nonzero:
        raise AssertionError("%s: the table is not written whole" % name)
    return check_exact("%s, two launches" % name, again, first, torch)


def film_variant_check(torch, rs, name, got, want, args, base_out, act):
    """A K16 FiLM variant's output against its plain version's within the
    order bound (check_kernel), and against K1's / K2's output on the same
    inputs (`base_out`) bit for bit on every row one 64-edge chunk holds."""
    msgs, table, ranks = args
    rows = table.shape[0]
    terms = film_terms(torch, rs, msgs, table, ranks, act)
    err = check_kernel(name, got, want,
                       row_abs_sums(torch, rows, ranks, terms),
                       row_counts(torch, rows, ranks), torch)
    # K1, K2 and each K16 FiLM variant, whose blocks are whole numbers of
    # 64-edge chunks, sum a row that one chunk holds (or an empty one) in
    # stream order from 0.
    whole = chunk_span(torch, ranks, rows) <= 0
    check_exact("%s = the shipped kernel's on %d of %d rows"
                % (name, int(whole.sum()), rows), got[whole], base_out[whole],
                torch)
    return err


def film_design_check(torch, name, got, earlier, ranks):
    """A FiLM table of csrc/film_rows.cuh (K1-K4) against another kernel's
    on the same inputs that sums the same terms in the same order: their
    earlier design (K1 / K2: the K16 v3 variants at group 1,
    csrc/film_walk.cuh; K3 / K4: tools/earlier_designs.py), another form
    of the same kernel, or K4's d_gb against K2's. Each sums a row's terms
    per 64-edge chunk in stream order from 0 and adds the row's chunk
    partials in f32, so every row that is not a seam row (at most two
    partials, whose sum does not depend on their order) must be equal bit
    for bit."""
    rows = got.shape[0]
    fixed = ~seam_rows(torch, ranks, rows)
    return check_exact("%s on %d of %d rows"
                       % (name, int(fixed.sum()), rows), got[fixed],
                       earlier[fixed], torch)


def slices_design_check(torch, name, got, earlier, slice_ranks):
    """K12a's table over stream slices with disjoint rank rows against
    another kernel's on the same slices that sums each slice's rank runs
    in the same per-chunk order, chunks counted from the slice's own first
    edge (its earlier body, one launch a slice): equal bit for bit on
    every row that is not a seam row of its slice (film_design_check)."""
    rows = got.shape[0]
    seams = torch.zeros(rows, dtype=torch.bool, device=got.device)
    for ranks in slice_ranks:
        seams |= seam_rows(torch, ranks, rows)
    return check_exact("%s on %d of %d rows" % (name, int((~seams).sum()),
                                                 rows),
                       got[~seams], earlier[~seams], torch)


def segsum_t_design_check(torch, name, got, earlier, ranks):
    """K6a's [K, rows] table against its earlier body's on the same inputs
    (csrc/segsum_t.cu, csrc/segsum_t_walk.cu). Both sum a row's terms in
    each run of 8 edges (runs aligned to multiples of 8) in stream order
    from 0, so every row whose edges lie in at most two runs (two partials,
    whose f32 sum does not depend on their order) must be equal bit for
    bit; a row over three or more runs meets its partials in the
    redesign's scan order and in the earlier body's atomic order."""
    fixed = chunk_span(torch, ranks, got.shape[1], edges=8) <= 1
    return check_exact("%s on %d of %d rows"
                       % (name, int(fixed.sum()), got.shape[1]),
                       got[:, fixed], earlier[:, fixed], torch)


def film_bwd_design_check(torch, name, got, earlier, ranks):
    """K4's (d_msgs, d_gb) against another K4's on the same inputs: d_msgs,
    one rounded product an element, bit for bit; d_gb as
    film_design_check."""
    (dm, dgb), (dm_want, dgb_want) = got, earlier
    check_exact("%s d_msgs" % name, dm, dm_want, torch)
    return film_design_check(torch, "%s d_gb" % name, dgb, dgb_want, ranks)


def src_gather_check(torch, name, got, stream, ranks, fed):
    """K3's or K9's gather form (`got`) against its stream form on the
    stream (and K3's t rows) that rs._src_stream_inputs or rs._side_rows
    builds from the same tables, over a diluted stream: equal on every row
    that is not a seam row (film_design_check), and zero on every row that
    no real edge feeds (`fed` false): a fill slot must add an exact zero
    term."""
    film_design_check(torch, name, got, stream, ranks)
    if bool((got[~fed] != 0).any()):
        raise AssertionError("%s: fill slots reached the table" % name)


def earlier_design(torch, name, new, earlier, ranks, check=film_design_check,
                   other=None, variants=("elu", "relu"), timed=None,
                   bounds=None):
    """A redesigned kernel (`new(v)`) against its earlier design
    (`earlier(v)`) for each variant v: the activations elu (the main
    path's) and relu (the harness's) for K1-K4, gelu for K10, the shapes
    for K9, K12a and K7a, the tables for K6a. `check` (the same sums in
    the same order: film_design_check, or K12a's slices_design_check, K4's
    film_bwd_design_check, K6a's segsum_t_design_check; for K10, whose
    orders differ, each held to the plain version; `ranks` the ranks it
    takes, or a dict of them by variant), then each one's single-call and
    queued times, means of two timings each taken in turns (earlier, new,
    new, earlier; with `other`, another form of the new kernel that is
    checked and timed too: earlier, new, other, other, new, earlier).
    `timed(which, v)`, where given, is the call to time in place of the
    checked one; `bounds[v]` ({which: bound ms}) adds each time's ratio
    to its bound. Returns {v: times}."""
    out = {}
    for v in variants:
        fns = {"earlier": lambda: earlier(v), "new": lambda: new(v)}
        if other is not None:
            fns["other"] = lambda: other(v)
        rk = ranks[v] if isinstance(ranks, dict) else ranks
        want = fns["earlier"]()
        for which in list(fns)[1:]:
            got = fns[which]()
            torch.cuda.synchronize()
            check(torch, "%s (%s, %s) = its earlier design's"
                  % (name, v, which), got, want, rk)
        taken = collections.defaultdict(list)
        for which in list(fns) + list(fns)[::-1]:
            fn = fns[which] if timed is None else timed(which, v)
            taken[which + "_ms"].append(cuda_ms(fn))
            taken[which + "_queued_ms"].append(cuda_queued_ms(fn))
        out[v] = {k: statistics.mean(t) for k, t in taken.items()}
        if bounds is not None:
            for which, b in bounds[v].items():
                out[v][which + "_bound_ms"] = b
                out[v][which + "_queued_per_bound"] = (
                    out[v][which + "_queued_ms"] / b)
        print("  %s (%s): %.4f ms (%.4f queued); earlier design %.4f ms "
              "(%.4f queued)%s%s" % (
                  name, v, out[v]["new_ms"], out[v]["new_queued_ms"],
                  out[v]["earlier_ms"], out[v]["earlier_queued_ms"],
                  "" if other is None else "; other form %.4f ms (%.4f "
                  "queued)" % (out[v]["other_ms"], out[v]["other_queued_ms"]),
                  "" if bounds is None else "; queued / bound: %s" % (
                      ", ".join("%s %.2f (bound %.4f ms)" % (
                          which, out[v][which + "_queued_per_bound"], b)
                          for which, b in bounds[v].items()))))
    return out


def k16_phase(torch, rs, dev, graph):
    """K16: drive the two harnesses of tf_gnn_samples_torch/tools/ (their
    `run`, as their `main` does) with the launch counters set to 0, at the
    JAX tools' default shapes and at the tuned QM9 batch's (FiLM: E =
    161,792 on the batch's real fine ranks, D = 128; row gathers: E =
    161,792, D = 128, the 51,472-row coarse table K5b expands, f32); every
    K16 kernel must have launched. Then, with those launches read, hold
    each variant against its plain version on the same inputs: the row
    gathers exactly, the FiLM variants within the order bound and equal to
    K1 / K2 on every row that one 64-edge chunk holds (relu, as timed, and
    elu at the QM9 shape). Returns the kernels-line entries, one per
    variant (FiLM: per group), at the default shapes (row gathers: bf16),
    with the other shapes under `other_shapes`."""
    from tf_gnn_samples_torch.tools import film_fwd_ab, rowgather_prof

    flat = graph.flat
    fine = flat.tgt_rank
    e_qm9 = int(fine.numel())
    rows_qm9 = rs.rank_table_rows(graph.n_pad, 256)
    log = lambda line: print("  " + line)
    rs.reset_launches()
    t0 = time.time()
    print("K16 film harness, the JAX tool's shapes:")
    film = {"defaults": film_fwd_ab.run(301056, 320, device=dev, log=log)}
    print("K16 film harness, the tuned QM9 batch's fine ranks:")
    film["QM9"] = film_fwd_ab.run(e_qm9, 128, device=dev, ranks=fine,
                                  rows=int(flat.fine_to_flat.numel()),
                                  log=log)
    print("K16 row-gather harness, the JAX tool's shapes:")
    gathers = {"defaults": rowgather_prof.run(32768, 320, 8192, device=dev,
                                              log=log)}
    print("K16 row-gather harness, the tuned QM9 batch's K5b shapes:")
    gathers["QM9"] = rowgather_prof.run(e_qm9, 128, rows_qm9, device=dev,
                                        dtypes=("f32",), log=log)
    launched = {k: rs.LAUNCHES[k] for k in K16_KERNELS}
    print("K16 harnesses in %.1f s; launches %s" % (time.time() - t0,
                                                    launched))
    if not all(launched.values()):
        raise AssertionError("K16 kernels not launched: %s" % launched)

    entries = {}
    nbytes = {}  # (entry, shape) -> bytes its function moves, for the print

    def add(entry_name, kernel, label, row, err, other):
        """Fold one measured shape of a variant into its entry."""
        nbytes[entry_name, label] = row["nbytes"]
        shape = {k: row[k] for k in ("ms", "queued_ms", "plain_ms",
                                     "bound_ms", "launches")}
        shape.update(other, max_abs_err=err)
        if "zero_share" in row:
            shape["zero_share"] = row["zero_share"]
        entry = entries.get(entry_name)
        if entry is None:
            nops = row.get("nops", 0)
            bytes_ms = row["nbytes"] / HBM_BYTES_PER_S * 1e3
            entry = entries[entry_name] = dict(
                name=entry_name, kernel=kernel, route="cuda",
                source="tf_gnn_samples_torch/csrc/%s.cu"
                       % K16_SOURCES[kernel.rsplit("_", 1)[0]],
                replaces=REPLACES[kernel], launches=0, max_abs_err=0.0,
                ms=row["ms"], queued_ms=row["queued_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=("bytes" if bytes_ms >= nops / F32_FLOPS * 1e3
                          else "operations"),
                library_ms=other.get("library_ms"), shape=label,
                other_shapes={})
            entry.update((k, v) for k, v in other.items()
                         if k != "library_ms")
        else:
            entry["other_shapes"][label] = shape
        entry["launches"] += row["launches"]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)

    for label, halves in film.items():
        for half, rows in halves.items():
            base, variants = ((rs._film_fwd_impl, film_fwd_ab.fwd_variants)
                              if half == "fwd" else
                              (rs._film_bwd_dgb_impl,
                               film_fwd_ab.dgb_variants))
            for act in ("relu", "elu") if label == "QM9" else ("relu",):
                args = rows[0]["call"][2]
                base_out = base(*args, act=act)
                fns = {name: fn for name, _, fn in variants(act)}
                for row in rows:
                    plain = row["call"][1]
                    name = "film_%s_%s" % (half, row["name"].replace(
                        " g=", "_g"))
                    got = fns[row["name"]](*args)
                    torch.cuda.synchronize()
                    err = film_variant_check(
                        torch, rs, "%s (%s, %s)" % (name, label, act), got,
                        plain(*args, act=act), args, base_out, act)
                    if act == "relu":
                        add(name, row["kernel"], label, row, err,
                            dict(other=("K1 film_fwd" if half == "fwd"
                                        else "K2 film_bwd_dgb"),
                                 other_ms=row["base_ms"],
                                 other_queued_ms=row["base_queued_ms"],
                                 library_ms=None))
    for label, rows in gathers.items():
        for row in rows:
            fn, plain, args = row["call"]
            got = fn(*args)
            torch.cuda.synchronize()
            shape = "%s %s %s" % (label, row["dtype"], row["stream"])
            err = check_exact("%s (%s)" % (row["kernel"], shape), got,
                              plain(*args), torch)
            if row["kernel"] == "rowgather_onehot":
                # index_select computes no onehot function (no bf16
                # rounding, no zero rows): a yardstick, not a library call.
                other = dict(yardstick="torch.Tensor.index_select of the "
                                       "windowed stream",
                             yardstick_ms=row["library_ms"],
                             yardstick_queued_ms=row["library_queued_ms"],
                             library_ms=None)
            else:
                other = dict(library="torch.Tensor.index_select",
                             library_ms=row["library_ms"],
                             library_queued_ms=row["library_queued_ms"])
            add(row["kernel"], row["kernel"], shape, row, err, other)

    def versus(v):
        """The time a shape is compared with: K1 / K2, the library call or
        the yardstick."""
        key = next(k for k in ("other", "library", "yardstick")
                   if v.get(k + "_ms") is not None)
        return "%s %.4f (%.4f queued)" % (v[key], v[key + "_ms"],
                                          v[key + "_queued_ms"])

    print("K16 kernels (queued time / bound):")
    for entry in entries.values():
        shapes = dict({entry["shape"]: entry}, **entry["other_shapes"])
        print("  %s: %s" % (entry["name"], "; ".join(
            "%s %.4f ms (%.4f queued, %.2fx the bound %.4f of %d bytes), "
            "plain %.4f, %s"
            % (label, v["ms"], v["queued_ms"],
               v["queued_ms"] / v["bound_ms"], v["bound_ms"],
               nbytes[entry["name"], label], v["plain_ms"], versus(v))
            for label, v in shapes.items())))
    return list(entries.values())


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
    """K3, K9, K14 and K15b on a DILUTED src stream (K15b also against its
    earlier body and into NaN tables). The tuned QM9 batches
    have no fine rank window, so their src streams are undiluted; `graph`
    (ppi_like_graph) dilutes. Fill slots carry the SD_FILL key, which the
    passes clamp onto a zero row appended to their side table (K3's and
    K9's gather forms: which add zero without a table): each kernel is
    held against its plain version on that stream, and the rows no real
    edge feeds must be exactly zero. K3's and K9's gather forms must also
    equal their stream forms on every row that is not a seam row."""
    from tf_gnn_samples_torch.nn.layers import src_stream
    from tf_gnn_samples_torch.ops.graph import SD_FILL
    from tf_gnn_samples_torch.tools import earlier_designs

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
    # K3's gather form, as the fused FiLM backward calls it on this stream.
    gb3, g3 = randn(rpad, 2 * d), randn(rpad, d)
    t3n = randn(graph.num_edge_types * graph.n_pad, d)
    gather = rs._film_src_bwd_gather_impl(gb3, g3, fine, t3n,
                                          flat.src_from_rank, ranks,
                                          table_rows=rsrc, act=act)
    gcb3, t3 = rs._src_stream_inputs(gb3, g3, fine, t3n,
                                 flat.src_from_rank)
    check("film_src_bwd (gather form)", gather,
          rs._film_src_bwd_gather_plain(gb3, g3, fine, t3n,
                                        flat.src_from_rank, ranks, rsrc, act),
          per_row(torch, rsrc, ranks,
                  src_terms(torch, rs, gcb3, t3, ranks, act).abs()).float())
    src_gather_check(torch, "film_src_bwd gather form = stream form "
                     "(diluted)", gather,
                     rs._film_src_bwd_impl(gcb3, t3, ranks, table_rows=rsrc,
                                           act=act), ranks, fed)
    side = torch.randn((rpad, d + 3 * heads), generator=gen, device=dev)
    side[:, d + heads:d + 2 * heads] = 0.5 + 4 * torch.rand(
        (rpad, heads), generator=gen, device=dev)
    side9 = side.to(torch.bfloat16)
    gcb9, t9 = gathered(side9), randn(rsrc, d + heads)
    k9_abs, _, k9_slack = rgat_src_bwd_bounds(torch, rs, gcb9, t9, ranks,
                                              rsrc, heads)
    stream9 = rs._rgat_src_bwd_impl(gcb9, t9, ranks, table_rows=rsrc,
                                    num_heads=heads, clamp=50.0)
    check("rgat_src_bwd", stream9,
          rs._rgat_src_bwd_plain(gcb9, t9, ranks, rsrc, heads, 50.0),
          k9_abs, term_ulps=1, slack=k9_slack)
    # K9's gather form, as the fused RGAT backward calls it on this stream.
    gather9 = rs._rgat_src_bwd_gather_impl(side9, fine, t9, ranks,
                                           table_rows=rsrc, num_heads=heads,
                                           clamp=50.0)
    check("rgat_src_bwd (gather form)", gather9,
          rs._rgat_src_bwd_gather_plain(side9, fine, t9, ranks, rsrc, heads,
                                        50.0),
          k9_abs, term_ulps=1, slack=k9_slack)
    src_gather_check(torch, "rgat_src_bwd gather form = stream form "
                     "(diluted)", gather9, stream9, ranks, fed)
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
    got14 = rs._emlp1_src_bwd_impl(gcb14, t14, cols14, w14, e_real, ranks,
                                   table_rows=rsrc, act="gelu")
    emlp1_src_bwd_tc_check(
        torch, rs, got14, rs._emlp1_src_bwd_plain(
            gcb14, t14, cols14, w14, e_real, ranks, rsrc, "gelu"),
        gcb14, t14, cols14, w14, e_real, ranks, rsrc, "gelu")
    if bool((got14[~fed] != 0).any()):
        raise AssertionError("emlp1_src_bwd: fill slots reached the table")
    emlp1_src_bwd_fits_check(rs)
    # K15b on the diluted stream: the C rows gathered from a fine-rank
    # table (fill slots read its zero row), a random packed mask.
    lanes = rs._mask_lanes(d)
    mask = torch.zeros((e_sd, lanes), device=dev)
    mask[:, :d // 16] = torch.randint(0, 2 ** 16, (e_sd, d // 16),
                                      generator=gen, device=dev).float()
    c15 = gathered(randn(rpad, d))
    for leak in (0.0, 0.2):
        got15 = rs._masked_segsum_impl(mask, c15, ranks, table_rows=rsrc,
                                       leak=leak)
        check("masked_segsum (leak %g)" % leak, got15,
              rs._masked_segsum_plain(mask, c15, ranks, rsrc, leak),
              torch.zeros((rsrc, d), device=dev).index_add_(
                  0, ranks, masked_terms(torch, rs, mask, c15, leak).abs()))
        # The diluted stream's runs span up to three chunks, and rows past
        # its last rank are reached by no edge.
        masked_segsum_design_check(
            torch, rs, "masked_segsum (leak %g, diluted) = its earlier "
            "design's" % leak, got15, earlier_designs.masked_segsum_walk(
                mask, c15, ranks, table_rows=rsrc, leak=leak),
            mask, c15, ranks, leak)
        masked_segsum_table_check(
            torch, "masked_segsum (leak %g, diluted) into a NaN table" % leak,
            masked_segsum_nan_tables(torch, rs, mask, c15, ranks, rsrc, leak),
            ranks)
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
                times[fused][name].append(cuda_ms(fn, warmup=2,
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


def expected_launches(label, layers, n_fwd, n_bwd,
                      streamed_types=QM9_STREAMED_TYPES):
    """Kernel launches of `n_fwd` forward passes, `n_bwd` of them with a
    backward pass, through `layers` message-passing layers of the path
    `label` (`streamed_types`: the edge types of the batch's type-major
    view that are not self loops, four on QM9, two on PPI); no other
    kernel runs. "none" is a branch without hand kernels (RGCN's and
    GGNN's dense adjacency matmuls, a plain branch). GNN-FiLM runs K1 forward and K2 + K3
    backward; with normalised messages K1 forward and, backward, K4 and
    K5a (the message gather's backward). RGCN and GGNN run K5a forward and
    K5b backward. An RGAT layer runs, forward, K6b for the target logits,
    K6a and K6b for the softmax denominator and K7a, on either branch;
    backward, the streamed branch runs K7b, the VJPs of those three K6
    launches (K6a twice, K6b once) and K5a in the message gather's
    backward, the fused branch K8, K6a and K6b for the softmax correction,
    K6a for the target logits' cotangent and K9. GNN-Edge-MLP0 is the
    fused FiLM pass (K1; K2 and K3). A GNN-Edge-MLP1 layer runs K11a and
    one K12a launch over every streamed edge type's slice forward;
    backward K12b per streamed type, K11b and K5a (the type-major gather's
    backward), or in its fused_src1 form K14 in place of that K5a. Its fused1 branch runs
    K5b (the target halves' expand) and K10a forward; K10b and two K5a
    (the backwards of the expand and of the source gather) backward. RGIN
    and GNN-Edge-MLP without the target state run the fused gather +
    segment-sum, RGDCN its fine-rank sibling: K5a forward and K5a
    backward. K13 and K15 run on no path (no model of either package
    calls them)."""
    want = {k: 0 for k in REPLACES}
    if label == "none":
        return want
    if label in ("RGIN", "GNN-Edge-MLP-ranked", "RGDCN"):
        want.update(segsum=layers * (n_fwd + n_bwd))
    elif label == "GNN-Edge-MLP1-fused1":
        want.update(expand=layers * n_fwd, typed_dense_agg=layers * n_fwd,
                    typed_dense_agg_bwd=layers * n_bwd,
                    segsum=2 * layers * n_bwd)
    elif label == "GNN-Edge-MLP1-src":
        want.update(expand_add_act=layers * n_fwd,
                    act_agg=layers * n_fwd,
                    act_agg_bwd=layers * n_bwd * streamed_types,
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
                    act_agg=layers * n_fwd,
                    act_agg_bwd=layers * n_bwd * streamed_types,
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
    """Train `path.model` at its tuned QM9 config for TUNED_OVERRIDES'
    epoch, test its checkpoint; returns the training run's launches, and the step times
    with the launches counted in one train step."""
    from tf_gnn_samples_torch import train as train_cli
    from tf_gnn_samples_torch import test as test_cli
    from tf_gnn_samples_torch.tasks.base import DataFold

    import torch

    out = os.path.join(OUT, path.label)
    os.makedirs(out, exist_ok=True)
    args = train_cli.get_train_args([
        path.model, "QM9", "--data-path", DATA, "--result-dir", out,
        "--quiet", "--model-param-overrides",
        json.dumps(dict(TUNED_OVERRIDES, **path.overrides))])
    torch.cuda.reset_peak_memory_stats()
    rs.reset_launches()
    t0 = time.time()
    (model,) = train_cli.run(args)
    launches = dict(rs.LAUNCHES)
    forms = dict(rs.FORM_LAUNCHES)
    train_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = (model.params["graph_num_layers"]
              * model.params["graph_num_timesteps_per_layer"])
    n_train = model.batches_run[DataFold.TRAIN]
    n_valid = model.batches_run[DataFold.VALIDATION]
    want = expected_launches(path.label, layers, n_train + n_valid, n_train)
    print("%s main path: %d train and %d valid batches in %.1f s, peak "
          "device memory %.2f GB; launches %s, expected %s"
          % (path.label, n_train, n_valid, train_s, peak_gb, launches, want))
    if launches != want:
        raise AssertionError("kernel launches %s != expected %s"
                             % (launches, want))
    # The fused RGAT backward reads the side table through K9's gather form.
    want_forms = {"rgat_src_bwd gather": want["rgat_src_bwd"],
                  "rgat_src_bwd stream": 0}
    print("%s main path: K9 launches by form %s, expected %s"
          % (path.label, forms, want_forms))
    if forms != want_forms:
        raise AssertionError("K9 forms %s != expected %s" % (forms,
                                                             want_forms))
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


# The cache phase: the main path (GNN-FiLM, tuned QM9 config) with its
# batches kept on the card, re-packed every 2 epochs, a full training
# state written every 2 epochs.
CACHE_OVERRIDES = {"max_epochs": 4, "cache_batches_on_device": True,
                   "repack_cached_every": 2, "checkpoint_every_n_epochs": 2}


def recorded_run(rs, args, state_copy=None):
    """Run the train CLI on `args` and record each of its epochs: the
    fold, the TRAIN / VALIDATION packs it started, the batches it ran,
    the ids of the batches its steps took and of the fold's cached batches
    after it, its kernel launches, its loss and graphs/s. `state_copy`
    (path): the training state written at epoch 2 is copied there. A
    restored training state is held against its file bit for bit
    (check_restored_state). Returns (model, records)."""
    from tf_gnn_samples_torch import train as train_cli
    from tf_gnn_samples_torch.runtime.model import SparseGraphModel as M
    from tf_gnn_samples_torch.tasks.qm9 import QM9_Task

    records, packs, stepped = [], [], []
    real_iter, real_epoch = QM9_Task.make_minibatch_iterator, M._run_epoch
    real_train, real_eval = M._train_step, M._eval_step
    real_save, real_restore = M.save_training_state, M.restore_training_state

    def counting_iter(self, data, fold, max_nodes):
        packs.append(fold)
        return real_iter(self, data, fold, max_nodes)

    def train_step(self, batch):
        stepped.append(id(batch))
        return real_train(self, batch)

    def eval_step(self, batch):
        stepped.append(id(batch))
        return real_eval(self, batch)

    def run_epoch(self, name, data, fold, quiet=False):
        del packs[:], stepped[:]
        before, n0 = dict(rs.LAUNCHES), self.batches_run[fold]
        result = real_epoch(self, name, data, fold, quiet)
        records.append({
            "fold": fold.name, "packed": len(packs),
            "batches": self.batches_run[fold] - n0, "stepped": list(stepped),
            "cached": [id(b) for b in self._batch_cache.get(fold, [])],
            "launches": {k: n - before[k] for k, n in rs.LAUNCHES.items()},
            "loss": result[0], "graphs_per_s": result[3]})
        return result

    def save(self, path, epoch, early_stop_state):
        real_save(self, path, epoch, early_stop_state)
        if state_copy and epoch == 2:
            shutil.copyfile(path, state_copy)

    def restore(self, path):
        resumed = real_restore(self, path)
        check_restored_state(self, path)
        return resumed

    with contextlib.ExitStack() as stack:
        for obj, name, value in (
                (QM9_Task, "make_minibatch_iterator", counting_iter),
                (M, "_run_epoch", run_epoch), (M, "_train_step", train_step),
                (M, "_eval_step", eval_step),
                (M, "save_training_state", save),
                (M, "restore_training_state", restore)):
            stack.enter_context(patched(obj, name, value))
        (model,) = train_cli.run(args)
    return model, records


def check_restored_state(model, path):
    """The weights, optimizer slots and step a model holds after
    restore_training_state(path) are the file's, bit for bit."""
    import pickle

    import numpy as np

    from tf_gnn_samples_torch.runtime.model import flatten_params

    with open(path, "rb") as f:
        state = pickle.load(f)
    names = list(flatten_params(model.model_params_tree))
    held = {k: v.detach().cpu().numpy() for k, v in zip(names,
                                                        model._leaves())}
    held.update({"%s/%s" % (slot, n): t.detach().cpu().numpy()
                 for slot, ts in model.opt_state.slots.items()
                 for n, t in zip(names, ts)})
    saved = dict(state["weights"])
    saved.update(state["opt_slots"])
    differ = sorted(k for k in saved if k not in held
                    or held[k].shape != saved[k].shape
                    or held[k].tobytes() != np.asarray(saved[k]).tobytes())
    if (differ or held.keys() != saved.keys()
            or model.opt_state.step != state["opt_step"]):
        raise AssertionError(
            "restored state differs from %s: %s (step %s, saved %s)"
            % (path, differ[:5] or sorted(held.keys() ^ saved.keys())[:5],
               model.opt_state.step, state["opt_step"]))


def check_cache_epochs(records, label, layers, repack_every):
    """Raise unless, over a run's epochs (`records`, recorded_run): TRAIN
    is packed at the run's first epoch and every `repack_every` epochs
    after it and VALIDATION at its first only; every epoch steps through
    each of the fold's cached batches once; each epoch launches exactly
    what `expected_launches` gives for the batches it ran (the cache
    changes no kernel); every loss is finite. (An epoch that packs steps
    through the uploaded batches, which are the cached ones unless dense
    adjacencies were attached to them.)"""
    for fold in ("TRAIN", "VALIDATION"):
        got = [r["packed"] for r in records if r["fold"] == fold]
        want = [int(i % repack_every == 0 if fold == "TRAIN" else i == 0)
                for i in range(len(got))]
        if got != want:
            raise AssertionError("%s packs by epoch %s, expected %s"
                                 % (fold, got, want))
    for i, r in enumerate(records):
        distinct = set(r["stepped"])
        once = (len(distinct) == len(r["stepped"]) == r["batches"]
                == len(r["cached"]) > 0)
        if not once or not (r["packed"] or distinct == set(r["cached"])):
            raise AssertionError(
                "epoch record %d (%s): %d batches run, %d steps over %d "
                "distinct batches, %d cached" % (
                    i, r["fold"], r["batches"], len(r["stepped"]),
                    len(set(r["stepped"])), len(r["cached"])))
        n_bwd = r["batches"] if r["fold"] == "TRAIN" else 0
        want = expected_launches(label, layers, r["batches"], n_bwd)
        if r["launches"] != want:
            raise AssertionError("epoch record %d (%s): launches %s, "
                                 "expected %s" % (i, r["fold"],
                                                  r["launches"], want))
        if not math.isfinite(r["loss"]):
            raise AssertionError("epoch record %d (%s): loss %s"
                                 % (i, r["fold"], r["loss"]))


class InlineIterator:
    """The prefetch thread's stand-in (utils/iterators.py
    ThreadedIterator): the same batches, packed on the calling thread."""

    def __init__(self, inner, max_queue_size=5):
        self._inner = iter(inner)

    def __enter__(self):
        return self._inner

    def __exit__(self, *exc):
        return False


def cache_phase(rs, path=PATHS[0], data=DATA, out=OUT, device="cuda",
                overrides=None, rates=True):
    """The main path with the device cache (CACHE_OVERRIDES, through the
    train CLI): 4 epochs whose packs, batches, launches and losses
    check_cache_epochs holds, then epochs 3-4 again in a fresh model
    resumed from the state written at epoch 2 (the restored weights and
    slots held to the file bit for bit, the losses finite). With `rates`,
    epoch 2's train and valid graphs/s cached, uncached (the prefetch
    thread packs) and uncached with the packing inline, each from a run
    of its own. Returns the launches of those runs."""
    from tf_gnn_samples_torch import train as train_cli
    from tf_gnn_samples_torch.runtime import model as model_mod

    out = os.path.join(out, path.label + "-cache")
    os.makedirs(out, exist_ok=True)
    total = {k: 0 for k in rs.LAUNCHES}

    def run(tag, params, extra=(), state_copy=None):
        args = train_cli.get_train_args([
            path.model, "QM9", "--data-path", data, "--result-dir",
            os.path.join(out, tag), "--quiet", "--device", device,
            "--model-param-overrides", json.dumps({
                "max_epochs": 2, **path.overrides, **params,
                **(overrides or {})})] + list(extra))
        rs.reset_launches()
        t0 = time.time()
        model, records = recorded_run(rs, args, state_copy)
        for k, n in rs.LAUNCHES.items():
            total[k] += n
        print("%s cache phase, %s run: %.1f s; by epoch and fold: packs %s, "
              "batches %s, graphs/s %s" % (
                  path.label, tag, time.time() - t0,
                  [r["packed"] for r in records],
                  [r["batches"] for r in records],
                  [round(r["graphs_per_s"], 2) for r in records]))
        return model, records

    state = os.path.join(out, "epoch2_training_state.pickle")
    model, cached = run("cached", CACHE_OVERRIDES, state_copy=state)
    layers = (model.params["graph_num_layers"]
              * model.params["graph_num_timesteps_per_layer"])
    check_cache_epochs(cached, path.label, layers,
                       CACHE_OVERRIDES["repack_cached_every"])
    _, resumed = run("resumed", CACHE_OVERRIDES, ["--resume", state])
    if [r["fold"] for r in resumed] != ["TRAIN", "VALIDATION"] * 2:
        raise AssertionError("the resumed run ran %s, not epochs 3-4"
                             % [r["fold"] for r in resumed])
    check_cache_epochs(resumed, path.label, layers,
                       CACHE_OVERRIDES["repack_cached_every"])
    if rates:
        _, uncached = run("uncached", {})
        with patched(model_mod, "ThreadedIterator", InlineIterator):
            _, inline = run("inline", {})
        print("%s epoch 2 train / valid graphs/s: cached %.2f / %.2f, "
              "uncached %.2f / %.2f, uncached with the packing inline "
              "%.2f / %.2f" % ((path.label,) + tuple(
                  r["graphs_per_s"] for run_ in (cached, uncached, inline)
                  for r in run_[2:4])))
    return total


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
                                      warmup=2, iters=5),
             "eval_step_ms": cuda_ms(lambda: model._eval_step(dev_batch),
                                     warmup=2, iters=5),
             "train_step_host_ms": host_enqueue_ms(
                 lambda: model._train_step(dev_batch), torch)}
    (times["train_step_busy_ms"], times["train_step_kernel_ms"],
     top) = device_profile(lambda: model._train_step(dev_batch), torch)
    print("%s: one batch of %d graphs: host packing %.1f ms, train step "
          "%.2f ms, eval step %.2f ms (device timeline); the host enqueues "
          "the train step in %.2f ms; the card is busy %.2f ms of the train "
          "step (idle %.0f%%)"
          % (label, batch.num_graphs, times["pack_ms"],
             times["train_step_ms"], times["eval_step_ms"],
             times["train_step_host_ms"], times["train_step_busy_ms"],
             100 * max(0.0, 1 - times["train_step_busy_ms"]
                       / times["train_step_ms"])))
    print("%s: the ten other device events with the most device time in one "
          "train step (torch.profiler: name, launches, ms): %s"
          % (label, json.dumps([[n, c, round(ms, 4)] for n, c, ms in top])))
    return times, step_launches


# ---- the PPI and citation-network phases ---------------------------------

# The test CLI's micro-F1 line as run_ppi_benchs.py:24 reads it (the JAX
# package's bench script, which this script does not import), and its
# accuracy line on a citation network.
MICRO_F1 = re.compile(r"^Metrics: Avg MicroF1: (0.\d+)")
ACCURACY = re.compile(r"^Metrics: Acc: (\d+\.\d+)%$")
TRAIN_EDGES_PER_S = re.compile(
    r"^ Train: loss: \S+ \|\| .* \|\| graphs/sec: \S+ \| nodes/sec: \d+ \| "
    r"edges/sec: (\d+)$")
# The reference's RGCN train epoch on PPI, on a V100 (bench.py:56, from the
# reference's README.md:34).
V100_EDGES_PER_S = 1952084
# The PPI phase cuts the train fold to 4 graphs and the valid and test
# folds to 1 each (a cut of depth: the graphs keep PPI's published size,
# the models their tuned widths); the headline runs the whole 20 / 2 / 2.
PPI_FOLDS_CUT = {"train": 4, "valid": 1, "test": 1}
PPI_EPOCHS = 1
HEADLINE_EPOCHS = 3
CITATION_EPOCHS = 3
PPI_PATHS = tuple(Path("PPI " + m, m, {}) for m in (
    "GNN-FiLM", "GNN-Edge-MLP0", "GNN-Edge-MLP1", "RGAT", "RGCN", "GGNN",
    "RGIN"))
CITATION_PATHS = tuple(Path("Pubmed " + m, m, {}) for m in ("GNN-FiLM",
                                                            "RGCN"))


def streamed_types(graph):
    """The edge types of a batch's type-major view that are not self
    loops (the slices K12 runs over)."""
    return tuple(graph.flat.tm_self).count(False)


def batch_branch(rs, model, graph):
    """The expected_launches label of the branch a batch of `graph`'s shape
    takes in `model`, from the port's own gates ("none": a branch without
    hand kernels): RGCN and GGNN take the dense adjacency matmuls up to
    use_dense_strategy's limit and K5 past it; RGAT its fused or streamed
    pass as rgat_fused_supported says at the batch's edges and table rows
    (or a plain branch); GNN-FiLM, GNN-Edge-MLP, RGIN and RGDCN what
    film_fused_branch, edge_mlp_branch, rgin_branch and rgdcn_sums_form
    answer (their scanned, unrolled, plain, dense and per-type forms run
    no hand kernel)."""
    from tf_gnn_samples_torch.nn import layers

    family = model.name(model.params)
    kw = model.layer_kwargs()
    if family in ("RGCN", "GGNN"):
        return "none" if model._wants_dense_adj(graph) else family
    if family == "GNN-FiLM":
        if not layers.film_fused_branch(kw["aggregation_strategy"],
                                        kw["message_aggregation_function"],
                                        kw["activation_function"]):
            return "none"
        return ("GNN-FiLM-normalised" if kw["normalize_by_num_incoming"]
                else "GNN-FiLM")
    if family.startswith("GNN-Edge-MLP"):
        d = model.params["hidden_size"]
        act = kw["activation_function"].lower()
        branch = layers.edge_mlp_branch(
            graph, activation_function=act,
            message_aggregation_function=kw["message_aggregation_function"],
            normalize_by_num_incoming=kw.get("normalize_by_num_incoming",
                                             False),
            use_target_state_as_input=kw["use_target_state_as_input"],
            num_edge_hidden_layers=kw["num_edge_hidden_layers"],
            typed_edge_scan=kw["typed_edge_scan"], w1_dims=(d, d))
        if branch == "tmajor1":
            return ("GNN-Edge-MLP1-src" if rs.emlp1_src_supported(
                act, d, streamed_types(graph)) else "GNN-Edge-MLP1")
        return {"fused0": "GNN-Edge-MLP0", "fused1": "GNN-Edge-MLP1-fused1",
                "ranked": "GNN-Edge-MLP-ranked"}.get(branch, "none")
    if family == "RGIN":
        return "RGIN" if layers.rgin_branch(
            graph,
            message_aggregation_function=kw["message_aggregation_function"],
            use_target_state_as_input=kw["use_target_state_as_input"],
            num_edge_MLP_hidden_layers=kw["num_edge_MLP_hidden_layers"],
            typed_edge_scan=kw["typed_edge_scan"]) == "ranked" else "none"
    if family == "RGDCN":
        if kw["message_aggregation_function"] not in (
                "sum", "unsorted_segment_sum"):
            return "none"
        return "RGDCN" if layers.rgdcn_sums_form(
            graph, kw["aggregation_strategy"],
            kw["typed_edge_scan"]) == "fine" else "none"
    if family == "RGAT":
        d, heads = model.params["hidden_size"], model.params["num_heads"]
        if not layers.rgat_streamed_branch(
                graph, d, heads, model.params.get("aggregation_strategy",
                                                  "auto")):
            return "none"
        fused = rs.rgat_fused_supported(
            graph.flat.src_flat.shape[0], d, heads,
            rs.rank_table_rows(graph.n_pad, 256),
            graph.flat.src_from_rank.shape[0])
        return "RGAT-fused" if fused else "RGAT-streamed"
    return family


@contextlib.contextmanager
def launches_per_batch(rs, record):
    """While the block runs, hold every train and eval step of every model
    to expected_launches for the branch its own batch takes
    (batch_branch; the batches of one fold may take up to
    batch_spec_buckets shapes), K9 to its gather form, and append
    (step, branch, n_pad) of each step to `record`."""
    from tf_gnn_samples_torch.runtime.model import SparseGraphModel as M

    real = {"_train_step": M._train_step, "_eval_step": M._eval_step}

    def checked(name):
        def step(self, batch):
            before = dict(rs.LAUNCHES)
            forms = dict(rs.FORM_LAUNCHES)
            out = real[name](self, batch)
            got = {k: n - before[k] for k, n in rs.LAUNCHES.items()}
            got_forms = {k: n - forms[k] for k, n in rs.FORM_LAUNCHES.items()}
            layers = (self.params["graph_num_layers"]
                      * self.params["graph_num_timesteps_per_layer"])
            branch = batch_branch(rs, self, batch.graph)
            want = expected_launches(branch, layers, 1,
                                     int(name == "_train_step"),
                                     streamed_types(batch.graph))
            want_forms = {"rgat_src_bwd gather": want["rgat_src_bwd"],
                          "rgat_src_bwd stream": 0}
            record.append((name, branch, batch.graph.n_pad))
            if got != want or got_forms != want_forms:
                raise AssertionError(
                    "%s on a batch of n_pad %d (%s branch): launches %s, "
                    "expected %s; K9 forms %s, expected %s" % (
                        name, batch.graph.n_pad, branch,
                        {k: n for k, n in got.items() if n},
                        {k: n for k, n in want.items() if n}, got_forms,
                        want_forms))
            return out
        return step

    with patched(M, "_train_step", checked("_train_step")), \
            patched(M, "_eval_step", checked("_eval_step")):
        yield record


def task_path_phase(rs, path, task_name, data, out, device="cuda",
                    overrides=None, task_overrides=None, metric=MICRO_F1,
                    test=True, profile=True, test_data=None):
    """Train `path.model` on `task_name` through the train CLI, at its
    tuned <task>_<model>.json (the class defaults where there is none)
    with `overrides` and the path's own, then (`test`) evaluate the
    checkpoint through the test CLI on `test_data` (default `data`):
    every step launches what its batch's
    branch needs (launches_per_batch), every Train, Valid and test loss is
    finite and the test's metric line parses with `metric`. Returns the
    model, the launches of both runs, the (step, branch, n_pad) of each
    step and, with `profile`, the peak device memory of training and
    step_times' readings."""
    import torch

    from tf_gnn_samples_torch import test as test_cli
    from tf_gnn_samples_torch import train as train_cli

    out = os.path.join(out, path.label.replace(" ", "-"))
    argv = [path.model, task_name, "--data-path", data, "--result-dir", out,
            "--quiet", "--device", device, "--model-param-overrides",
            json.dumps({**(overrides or {}), **path.overrides})]
    if task_overrides:
        argv += ["--task-param-overrides", json.dumps(task_overrides)]
    if profile:
        torch.cuda.reset_peak_memory_stats()
    rs.reset_launches()
    record = []
    t0 = time.time()
    with launches_per_batch(rs, record):
        (model,) = train_cli.run(train_cli.get_train_args(argv))
    result = {"launches": dict(rs.LAUNCHES), "seconds": time.time() - t0}
    for fold in ("Train", "Valid"):
        finite_log_values(model.log_file,
                          re.compile(r"^ %s: loss: (\S+) " % fold))
    if profile:
        result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if test:
        rs.reset_launches()
        with launches_per_batch(rs, record):
            tmodel = test_cli.test(model.best_model_file, test_data or data,
                                   out, quiet=True, device=device)
        for k, n in rs.LAUNCHES.items():
            result["launches"][k] += n
        finite_log_values(tmodel.log_file, re.compile(r"^Loss (\S+) on "))
        result["metric"] = finite_log_values(tmodel.log_file, metric)[-1]
    result["steps"] = collections.Counter(record)
    print("%s: %.1f s; steps by (step, branch, n_pad) %s; launches %s; %s"
          % (path.label, result["seconds"], dict(result["steps"]),
             {k: n for k, n in result["launches"].items() if n},
             "test metric %s" % result.get("metric")))
    if profile:
        result["times"], result["per_step"] = step_times(rs, model,
                                                         path.label)
        print("%s: peak device memory %.2f GB" % (path.label,
                                                  result["peak_gb"]))
    return model, result


def task_phase(rs, task_name, data, paths, epochs, out=OUT, device="cuda",
               overrides=None, task_overrides=None, metric=MICRO_F1,
               profile=True):
    """Each of `paths` on `task_name` for `epochs` epochs, then its
    checkpoint through the test CLI (task_path_phase): the PPI phase
    (PPI_PATHS at their tuned PPI_<model>.json, unchanged, on synthetic
    PPI cut to PPI_FOLDS_CUT) and the citation phase (CITATION_PATHS at
    their class defaults, as there is no hypers file for the task, on
    Pubmed-sized synthetic Planetoid data, data_kind pubmed, metric
    ACCURACY). Returns the launches of all paths and each path's
    result."""
    total = {k: 0 for k in rs.LAUNCHES}
    results = {}
    for path in paths:
        _, res = task_path_phase(
            rs, path, task_name, data, out, device,
            {"max_epochs": epochs, **(overrides or {})}, task_overrides,
            metric, profile=profile)
        for k, n in res["launches"].items():
            total[k] += n
        results[path.label] = res
    return total, results


def ppi_headline(rs, data, out=OUT, device="cuda", overrides=None,
                 profile=True, card=""):
    """RGCN at PPI_RGCN.json on the whole synthetic 20 / 2 / 2 fold with
    its batches kept on the card, for HEADLINE_EPOCHS epochs, twice: with
    the gate as it is (dense adjacency matmuls at every PPI pack) and
    with "aggregation_strategy": "pallas" (K5a forward, K5b backward).
    Prints the train edges/s of epochs 2-3 beside the reference's V100
    figure; a reading, not a claim. Returns the launches and the edges/s
    by strategy."""
    total = {k: 0 for k in rs.LAUNCHES}
    rates = {}
    for strategy in ("auto", "pallas"):
        path = Path("PPI RGCN headline " + strategy, "RGCN",
                    {"aggregation_strategy": strategy})
        model, res = task_path_phase(
            rs, path, "PPI", data, out, device,
            {"max_epochs": HEADLINE_EPOCHS, "cache_batches_on_device": True,
             **(overrides or {})}, test=False, profile=profile)
        for k, n in res["launches"].items():
            total[k] += n
        with open(model.log_file) as f:
            edges = [int(m.group(1)) for m in map(TRAIN_EDGES_PER_S.match, f)
                     if m]
        if len(edges) != HEADLINE_EPOCHS or not model._batch_cache:
            raise AssertionError("%s: train edges/s %s over %d epochs, "
                                 "cached folds %s" % (
                                     path.label, edges, HEADLINE_EPOCHS,
                                     list(model._batch_cache)))
        rates[strategy] = edges[1:]
        print("%s: train edges/s by epoch %s; epochs 2-%d mean %.0f, %.2fx "
              "the reference's V100 figure of %d edges/s; %s%s" % (
                  path.label, edges, HEADLINE_EPOCHS,
                  statistics.mean(edges[1:]),
                  statistics.mean(edges[1:]) / V100_EDGES_PER_S,
                  V100_EDGES_PER_S, card,
                  "; peak device memory %.2f GB" % res["peak_gb"]
                  if profile else ""))
    return total, rates


# ---- the VarMisuse phase ------------------------------------------------

# The test CLI's accuracy line as run_varmisuse_benchs.py:27 reads it.
VARMISUSE_ACCURACY = re.compile(r"^Metrics: Accuracy: (0.\d+)")
GRAPHS_PER_S = re.compile(
    r"^ (Train|Valid): loss: \S+ \|\| .* \|\| graphs/sec: (\S+) \|")
VARMISUSE_EPOCHS = 2
VARMISUSE_PATHS = tuple(Path("VarMisuse " + m, m, {}) for m in (
    "GNN-FiLM", "GNN-Edge-MLP0", "GNN-Edge-MLP1", "RGAT", "RGCN", "GGNN",
    "RGIN"))
# GNN-FiLM streams its train fold from disk through 4 spawned parse
# workers (ShardedSampleStream); the others hold it in memory.
VARMISUSE_STREAMED = {"GNN-FiLM": {"streaming_train_data": True,
                                   "streaming_parse_workers": 4}}
# The scan on the card: RGIN and GNN-Edge-MLP1 at their tuned configs on
# one batch of theirs, RGDCN (no VarMisuse_RGDCN.json: class defaults)
# on a batch cut to 10,000 nodes.
SCAN_MODELS = (("RGIN", None), ("GNN-Edge-MLP1", None), ("RGDCN", 10000))


def varmisuse_params(model, overrides=None):
    """(model class, model params, task params) of `model` at its tuned
    VarMisuse_<model>.json (class defaults where there is none) with
    `overrides`, dropout off."""
    from tf_gnn_samples_torch.train import HYPERS_DIR
    from tf_gnn_samples_torch.utils.registry import name_to_model_class

    cls, extra = name_to_model_class(model)
    params, task_params = cls.default_params(), {}
    params.update(extra)
    hypers = os.path.join(HYPERS_DIR, "VarMisuse_%s.json" % model)
    if os.path.exists(hypers):
        with open(hypers) as f:
            tuned = json.load(f)
        params.update(tuned["model_params"])
        task_params = tuned["task_params"]
    params.update(overrides or {})
    params["graph_layer_input_dropout_keep_prob"] = 1.0
    return cls, params, task_params


def varmisuse_batch(fold_dir, max_nodes, **task_params):
    """(task, the first batch, unshuffled, of the VarMisuse fold directory
    `fold_dir` at `max_nodes` a batch)."""
    from tf_gnn_samples_torch.tasks.base import DataFold
    from tf_gnn_samples_torch.tasks.varmisuse import VarMisuse_Task

    task = VarMisuse_Task({**VarMisuse_Task.default_params(), **task_params})
    data = task.load_eval_data_from_path(fold_dir)
    return task, next(task.make_minibatch_iterator(
        data, DataFold.VALIDATION, max_nodes))


def varmisuse_phase(rs, data, out=OUT, device="cuda", overrides=None,
                    profile=True, paths=VARMISUSE_PATHS):
    """The seven families on synthetic VarMisuse data through the train
    CLI at their tuned VarMisuse_<model>.json, for VARMISUSE_EPOCHS epochs,
    then the test CLI on graphs-test (task_path_phase: every step held to
    its own batch's branch, finite losses, the accuracy line parsed with
    run_varmisuse_benchs.py's regex). Every batch must take a kernel
    branch (the tuned configs' gates: none answers "none"); GNN-FiLM's
    train fold must have streamed through its parse pool, which is closed
    after. Prints each path's epoch-2 train and valid graphs/s. Returns
    the launches of all paths and each path's result."""
    from tf_gnn_samples_torch.tasks.base import DataFold

    total = {k: 0 for k in rs.LAUNCHES}
    results = {}
    for path in paths:
        streamed = VARMISUSE_STREAMED.get(path.model, {})
        model, res = task_path_phase(
            rs, path, "VarMisuse", data, out, device,
            {"max_epochs": VARMISUSE_EPOCHS, **(overrides or {})}, streamed,
            VARMISUSE_ACCURACY, profile=profile,
            test_data=os.path.join(data, "graphs-test"))
        fold = model.task._loaded_data[DataFold.TRAIN]
        pool = getattr(fold, "_pool", None)
        if getattr(fold, "is_streaming", False):
            fold.close()
        if bool(streamed) != getattr(fold, "is_streaming", False) or (
                streamed and pool is None):
            raise AssertionError("%s: train fold streamed %s, parse pool %s, "
                                 "asked %s" % (path.label, getattr(
                                     fold, "is_streaming", False), pool,
                                               streamed))
        branches = {branch for _, branch, _ in res["steps"]}
        if "none" in branches:
            raise AssertionError("%s: batches without a kernel branch: %s"
                                 % (path.label, dict(res["steps"])))
        with open(model.log_file) as f:
            rates = [(m.group(1), float(m.group(2)))
                     for m in map(GRAPHS_PER_S.match, f) if m]
        if len(rates) != 2 * VARMISUSE_EPOCHS:
            raise AssertionError("%s: graphs/s lines %s" % (path.label,
                                                            rates))
        res["graphs_per_s"] = dict(rates[-2:])
        print("%s: epoch %d graphs/s train %.2f, valid %.2f; branches %s"
              % (path.label, VARMISUSE_EPOCHS, res["graphs_per_s"]["Train"],
                 res["graphs_per_s"]["Valid"], sorted(branches)))
        for k, n in res["launches"].items():
            total[k] += n
        results[path.label] = res
    return total, results


def parse_rates(data, workers=4):
    """The streaming loader's parse rate over the train fold's shards
    (graphs/s of an epoch of ShardedSampleStream.iter_samples, 23 edge
    types), inline over one epoch and with `workers` spawned parse workers
    over two epochs on one stream (the pool is made in the first), the
    pool closed after."""
    from tf_gnn_samples_torch.tasks.varmisuse import ShardedSampleStream

    fold = os.path.join(data, "graphs-train")
    paths = sorted(os.path.join(fold, f) for f in os.listdir(fold)
                   if f.endswith(".gz"))
    rates = {}
    for n in (0, workers):
        stream = ShardedSampleStream(paths, 19, 5, True, parse_workers=n)
        try:
            for epoch in ((1, 2) if n else (1,)):
                t0 = time.perf_counter()
                count = sum(1 for _ in stream.iter_samples(shuffle=True))
                rates[(n, epoch)] = count / (time.perf_counter() - t0)
        finally:
            stream.close()
        if count != len(stream):
            raise AssertionError("stream of %d graphs gave %d" % (
                len(stream), count))
    print("VarMisuse streaming parse (%d shards, %d graphs): graphs/s by "
          "(workers, epoch) %s" % (len(paths), count, {
              "%d workers, epoch %d" % k: round(v, 1)
              for k, v in rates.items()}))
    return rates


def loss_and_grads_of(torch, model, dev_batch):
    """The model's loss on a device batch, without dropout, and its
    gradients as f64 CPU tensors."""
    loss, _ = model._forward(model.model_params_tree, dev_batch, None)
    grads = torch.autograd.grad(loss, model._leaves())
    return float(loss.detach()), [g.cpu().double() for g in grads]


def scan_phase(torch, rs, data, out=OUT, device="cuda", overrides=None,
               profile=True):
    """The per-type scan on the card (SCAN_MODELS): each model's loss and
    gradients with typed_edge_scan "scan" against the same weights at
    "unroll" on one VarMisuse batch (its tuned config's batch size, or
    the cut), both f32 branches in other sum orders, held with
    reference_agrees' bounds; "scan" must launch no hand kernel. Times
    one train step at "scan", "unroll" and "auto" (the kernel branch where
    the gate takes one) on the batch, with `profile`. Returns the times
    and branches by model."""
    from tf_gnn_samples_torch.runtime.model import (batch_to_device,
                                                    params_to_jax)

    results = {}
    for model_name, cut in SCAN_MODELS:
        cls, params, task_params = varmisuse_params(model_name, overrides)
        task, batch = varmisuse_batch(
            os.path.join(data, "graphs-valid"),
            cut or params["max_nodes_in_batch"], **task_params)
        dev_batch = batch_to_device(batch, torch.device(device))
        weights = None
        runs = {}
        for scan in ("scan", "unroll", "auto"):
            model = cls(dict(params, typed_edge_scan=scan), task, "scan",
                        out, device=device)
            if weights is None:
                weights = params_to_jax(model.model_params_tree)
            model.load_weights(weights)
            rs.reset_launches()
            loss, grads = loss_and_grads_of(torch, model, dev_batch)
            launches = {k: n for k, n in rs.LAUNCHES.items() if n}
            branch = batch_branch(rs, model, batch.graph)
            runs[scan] = {"loss": loss, "grads": grads, "launches": launches,
                          "branch": branch}
            if profile:
                runs[scan]["train_step_ms"] = cuda_ms(
                    lambda: model._train_step(dev_batch), warmup=1, iters=3)
            del model
        if runs["scan"]["launches"] or runs["scan"]["branch"] != "none":
            raise AssertionError("%s scan: branch %s, launches %s" % (
                model_name, runs["scan"]["branch"], runs["scan"]["launches"]))
        reference_agrees("%s scan against unroll (n_pad %d, %d edge types)"
                         % (model_name, batch.graph.n_pad,
                            batch.graph.num_edge_types),
                         runs["scan"]["loss"], runs["scan"]["grads"],
                         runs["unroll"]["loss"], runs["unroll"]["grads"],
                         float("nan"), {})
        results[model_name] = {
            k: {f: v[f] for f in ("train_step_ms", "branch", "launches")
                if f in v} for k, v in runs.items()}
        print("%s on a VarMisuse batch (n_pad %d, %d edges, %d types): %s"
              % (model_name, batch.graph.n_pad,
                              batch.graph.flat.src_flat.shape[0],
                              batch.graph.num_edge_types, json.dumps(
                                  results[model_name])))
    return results


def k12_varmisuse(torch, rs, graph, d=128):
    """K12a (one launch over every streamed type's slice, as a layer calls
    it) and K12b (a launch a streamed type) on the type-major stream of a
    VarMisuse batch (GNN-Edge-MLP1's): each held against its plain version
    (K12a within the order bound, K12b bit for bit) and timed single and
    queued beside its bound (K12b: all of a layer's launches together)."""
    gen = torch.Generator(device=graph.flat.tm_rank.device).manual_seed(12)
    dev = graph.flat.tm_rank.device
    flat = graph.flat
    tm, offs = flat.tm_rank, flat.tm_offs
    rpad = rs.fine_rank_table_rows(graph.n_pad, graph.num_edge_types,
                                   tm.shape[0], 256)
    slices = [(offs[l], offs[l + 1]) for l in range(len(offs) - 1)
              if not flat.tm_self[l] and offs[l + 1] > offs[l]]
    e = offs[-1]
    y = torch.randn((e, d), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((rpad, d), generator=gen, device=dev).to(torch.bfloat16)
    pieces = [(y[lo:hi], tm[lo:hi]) for lo, hi in slices]
    idx = torch.cat([torch.arange(lo, hi, device=dev) for lo, hi in slices])
    ranks = tm.index_select(0, idx)
    terms = rs._bf16_terms(rs._ACTS["gelu"][0](y.index_select(0, idx).float()))
    el = int(idx.numel())
    n_l = sum(int(tm[hi - 1]) - int(tm[lo]) + 1 for lo, hi in slices)
    check_kernel("act_agg (VarMisuse, %d slices)" % len(slices),
                 rs._act_agg_slices_impl(pieces, table_rows=rpad, act="gelu"),
                 rs._act_agg_slices_plain(pieces, rpad, "gelu"),
                 row_abs_sums(torch, rpad, ranks, terms),
                 row_counts(torch, rpad, ranks), torch)
    table = torch.zeros((rpad, d), device=dev)
    k12a = lambda: rs._act_agg_slices_impl(pieces, table_rows=rpad,
                                           act="gelu", out=table)
    bwd = lambda: [rs._act_agg_bwd_impl(m, g, r, act="gelu")
                   for m, r in pieces]
    for (m, r), got in zip(pieces, bwd()):
        if not torch.equal(got, rs._act_agg_bwd_plain(m, g, r, "gelu")):
            raise AssertionError("act_agg_bwd (VarMisuse) disagrees with its "
                                 "plain version")
    row = {
        "slices": len(slices), "edges": el,
        "act_agg": {"launches": 1, "ms": cuda_ms(k12a),
                    "queued_ms": cuda_queued_ms(k12a),
                    "plain_ms": cuda_ms(lambda: rs._act_agg_slices_plain(
                        pieces, rpad, "gelu")),
                    "bound_ms": bound_ms(el * d * 2 + el * 4 + n_l * d * 4,
                                         30 * el * d)},
        "act_agg_bwd": {"launches": len(slices), "ms": cuda_ms(bwd),
                        "queued_ms": cuda_queued_ms(bwd),
                        "plain_ms": cuda_ms(lambda: [
                            rs._act_agg_bwd_plain(m, g, r, "gelu")
                            for m, r in pieces]),
                        "bound_ms": bound_ms(2 * el * d * 2 + el * 4
                                             + n_l * d * 2, 45 * el * d)},
    }
    print("K12 at a VarMisuse batch (n_pad %d, %d streamed slices, %d "
          "edges, D %d): %s" % (graph.n_pad, len(slices), el, d,
                                json.dumps(row)))
    return row


def varmisuse_data():
    """(the synthetic VarMisuse data of bench.py:59's size, seed 0: 150 /
    20 / 20 graphs of 1,600-2,599 nodes; a small fold, seed 1: 4 valid
    graphs of 150-249 nodes for the references), under DATA_OUT."""
    from tf_gnn_samples_torch.tools.synthetic_data import (
        make_synthetic_varmisuse)

    return (make_synthetic_varmisuse(os.path.join(DATA_OUT, "varmisuse"),
                                     seed=0),
            make_synthetic_varmisuse(
                os.path.join(DATA_OUT, "varmisuse_small"), seed=1,
                folds={"valid": 4}, min_nodes=150, max_nodes=250))


# The card-against-CPU references on the small VarMisuse batch: the seven
# families (RGCN and GGNN also on K5, which their tuned batches take; at
# this size their gate takes the dense matmuls), and the scan.
VARMISUSE_REFERENCES = VARMISUSE_PATHS + tuple(
    Path("VarMisuse %s pallas" % m, m, {"aggregation_strategy": "pallas"})
    for m in ("RGCN", "GGNN")) + tuple(
    Path("VarMisuse %s scan" % m, m, {"typed_edge_scan": "scan"})
    for m, _ in SCAN_MODELS)


def vm_reference_phase(torch, rs, small, paths=VARMISUSE_REFERENCES,
                       card="cuda"):
    """reference_phase on the small VarMisuse batch (4 graphs) of 22 edge
    types, or 23 where the path's config adds self loops, at 4 of the
    tuned configs' 6-10 layers (their widths): at 10 layers a 1e-6
    relative weight nudge moves GNN-FiLM's CPU loss by 2.0e-3 on this
    batch, and the card's last-bit differences grow as far."""
    batches = {}
    for path in paths:
        _, _, task_params = varmisuse_params(path.model)
        loops = bool(task_params.get("add_self_loop_edges"))
        if loops not in batches:
            batches[loops] = varmisuse_batch(
                os.path.join(small, "graphs-valid"), 5000,
                add_self_loop_edges=loops)
        task, batch = batches[loops]
        reference_phase(torch, rs, path, card=card, task_name="VarMisuse",
                        task=task, batch=batch,
                        overrides={"graph_num_layers": 4})


def reference_agrees(name, lc, gc, lp, gp, sensitivity, launches):
    """Raise unless the card's loss `lc` and gradients `gc` agree with the
    CPU's `lp` / `gp`: the loss within 1e-2 and every tensor's gradient
    within 5e-2 relative, by norm. The bf16 message streams make an
    untrained deep model sensitive to last-bit differences, and the
    card's f32 matmuls and sums differ from the CPU's in the last bits:
    `sensitivity` (how far weights scaled by 1 + 1e-6 noise move the CPU
    loss) is printed beside the difference. A wrong kernel moves the
    card-CPU difference by O(1)."""
    import numpy as np

    rel_loss = abs(lc - lp) / abs(lp)
    rel_grad = max(float((a - b).norm() / b.norm().clamp(min=1e-30))
                   for a, b in zip(gc, gp))
    print("%s reference: loss card %.7f cpu %.7f (rel %.2e); max per-tensor "
          "relative gradient difference %.2e; CPU loss moved %.2e by a 1e-6 "
          "relative weight nudge; card launches %s"
          % (name, lc, lp, rel_loss, rel_grad, sensitivity, launches))
    if not (np.isfinite(lc) and rel_loss < 1e-2 and rel_grad < 5e-2):
        raise AssertionError("%s: card and CPU disagree on the small batch"
                             % name)


def reference_phase(torch, rs, path, card="cuda", task_name="QM9",
                    task=None, batch=None, overrides=None):
    """Full-width model (tuned <task_name>_<model>.json, or the class
    defaults where the repository has none, as for RGDCN and the citation
    networks) of `path` on a small batch (default: the first 600-node QM9
    pack): the card's kernels against the CPU's plain versions, same
    weights, no dropout. On QM9, at 600 nodes RGCN, GGNN and RGDCN would
    take the dense strategy ("auto"), so they are set to the ranked one
    ("pallas") and must launch K5 (RGDCN: its fine form); RGAT takes the
    same branch under either. On another task the path keeps its own
    overrides and must launch the kernels of the branch batch_branch
    gives the batch. `overrides` cut a reference's depth where its
    untrained model amplifies last-bit differences past the check's
    bounds."""
    import numpy as np

    from tf_gnn_samples_torch.runtime.model import batch_to_device, params_to_jax
    from tf_gnn_samples_torch.train import HYPERS_DIR
    from tf_gnn_samples_torch.utils.registry import name_to_model_class

    model_name = path.label
    cls, extra = name_to_model_class(path.model)
    params = cls.default_params()
    params.update(extra)
    hypers_file = os.path.join(HYPERS_DIR, "%s_%s.json" % (task_name,
                                                          path.model))
    if os.path.exists(hypers_file):
        with open(hypers_file) as f:
            params.update(json.load(f)["model_params"])
    params.update(path.overrides)
    params.update(overrides or {})
    params["graph_layer_input_dropout_keep_prob"] = 1.0
    if task is None:
        if path.model != "GNN-FiLM":
            params["aggregation_strategy"] = "pallas"
        task, batch = first_batch(600, "VALIDATION")
    out = os.path.join(OUT, model_name.replace(" ", "-"))
    cpu_model = cls(dict(params), task, "ref", out, device="cpu")
    weights = params_to_jax(cpu_model.model_params_tree)
    branch = (model_name if task_name == "QM9"
              else batch_branch(rs, cpu_model, batch.graph))

    def loss_and_grads(dev, w):
        model = cls(dict(params), task, "ref", out, device=dev)
        model.load_weights(w)
        return loss_and_grads_of(torch, model,
                                 batch_to_device(batch, model.device))

    rs.reset_launches()
    lc, gc = loss_and_grads(card, weights)
    launches = dict(rs.LAUNCHES)
    used = [k for k, n in expected_launches(
        branch, 1, 1, 1, streamed_types(batch.graph)).items() if n]
    if not all(launches[k] > 0 for k in used):
        raise AssertionError("%s reference (%s branch): launches %s"
                             % (model_name, branch, launches))
    lp, gp = loss_and_grads("cpu", weights)
    rng = np.random.RandomState(1)
    nudged = {k: v * (1 + 1e-6 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in weights.items()}
    sensitivity = abs(loss_and_grads("cpu", nudged)[0] - lp) / abs(lp)
    reference_agrees("%s (%s branch)" % (model_name, branch), lc, gc, lp, gp,
                     sensitivity, {k: n for k, n in launches.items() if n})


def report_hand_kernels(label, times):
    """Print the hand kernels' profiled device time in one train step
    (step_times) beside the card's busy time."""
    traced = times["train_step_kernel_ms"]
    print("%s: device time of the hand-written kernels in one train "
          "step (torch.profiler) %s: %.2f ms, %.1f%% of the card's busy "
          "time"
          % (label, {k: round(v, 4) for k, v in sorted(traced.items())},
             sum(traced.values()),
             100 * sum(traced.values()) / times["train_step_busy_ms"]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    kernels, graph = kernel_phase(torch, rs, torch.device("cuda"))
    kernel_ms = {k["name"]: k.get("mean_slice_ms", k["ms"]) for k in kernels}
    queued_ms = {k["name"]: k.get("mean_slice_queued_ms", k["queued_ms"])
                 for k in kernels}
    kernels += k16_phase(torch, rs, torch.device("cuda"), graph)
    del graph
    total = {k: 0 for k in rs.LAUNCHES}
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
        report_hand_kernels(path.label, times)
    t0 = time.time()
    for name, n in cache_phase(rs).items():
        total[name] += n
    print("cache phase: %.1f s" % (time.time() - t0))

    from tf_gnn_samples_torch.tools.synthetic_data import (
        make_synthetic_planetoid, make_synthetic_ppi)

    t0 = time.time()
    ppi_cut = make_synthetic_ppi(os.path.join(DATA_OUT, "ppi_cut"), seed=0,
                                 folds=PPI_FOLDS_CUT)
    ppi_full = make_synthetic_ppi(os.path.join(DATA_OUT, "ppi"), seed=0)
    ppi_small = make_synthetic_ppi(
        os.path.join(DATA_OUT, "ppi_small"), seed=1,
        folds={"train": 1, "valid": 1, "test": 1}, min_nodes=400,
        max_nodes=401)
    pubmed = make_synthetic_planetoid(os.path.join(DATA_OUT, "pubmed"),
                                      seed=0)
    print("synthetic PPI (20 / 2 / 2 graphs and the 4 / 1 / 1 cut) and "
          "Pubmed-sized Planetoid data: %.1f s" % (time.time() - t0))
    for phase, run in (
            ("PPI phase", lambda: task_phase(rs, "PPI", ppi_cut, PPI_PATHS,
                                             PPI_EPOCHS)),
            ("PPI headline", lambda: ppi_headline(rs, ppi_full, card=card)),
            ("citation phase", lambda: task_phase(
                rs, "CitationNetwork", pubmed, CITATION_PATHS,
                CITATION_EPOCHS, task_overrides={"data_kind": "pubmed"},
                metric=ACCURACY))):
        t0 = time.time()
        launched, results = run()
        for name, n in launched.items():
            total[name] += n
        for label, res in results.items():
            if "times" in res:
                report_hand_kernels(label, res["times"])
        print("%s: %.1f s; launches %s" % (
            phase, time.time() - t0,
            {k: n for k, n in launched.items() if n}))
    t0 = time.time()
    vm, vm_small = varmisuse_data()
    print("synthetic VarMisuse data (150 / 20 / 20 graphs, and a small "
          "fold): %.1f s" % (time.time() - t0))
    t0 = time.time()
    launched, results = varmisuse_phase(rs, vm)
    for name, n in launched.items():
        total[name] += n
    for label, res in results.items():
        report_hand_kernels(label, res["times"])
    emlp1 = results["VarMisuse GNN-Edge-MLP1"]["times"]
    k12b_ms = sum(ms for k, ms in emlp1["train_step_kernel_ms"].items()
                  if k.startswith("act_agg_bwd"))
    print("VarMisuse GNN-Edge-MLP1: K12b takes %.4f ms of the train step's "
          "%.2f busy ms (%.1f%%) in %d launches a step" % (
              k12b_ms, emlp1["train_step_busy_ms"],
              100 * k12b_ms / emlp1["train_step_busy_ms"],
              results["VarMisuse GNN-Edge-MLP1"]["per_step"].get(
                  "act_agg_bwd", 0)))
    print("VarMisuse phase: %.1f s; launches %s" % (
        time.time() - t0, {k: n for k, n in launched.items() if n}))
    t0 = time.time()
    parse_rates(vm)
    scan_phase(torch, rs, vm)
    _, params, task_params = varmisuse_params("GNN-Edge-MLP1")
    _, batch = varmisuse_batch(os.path.join(vm, "graphs-valid"),
                               params["max_nodes_in_batch"], **task_params)
    from tf_gnn_samples_torch.ops.graph import graph_to_device
    k12_varmisuse(torch, rs, graph_to_device(batch.graph, "cuda"),
                  params["hidden_size"])
    del batch
    print("VarMisuse parse rates, scan and K12 rows: %.1f s"
          % (time.time() - t0))
    for k in kernels:
        # K16 entries keep their harness launches; no model path runs them
        # (expected_launches held their counters at 0 on every path).
        if "kernel" in k:
            k["launches_model_paths"] = total[k["kernel"]]
        else:
            k["launches"] = total[k["name"]]
    rgat_branch_phase(torch, rs, torch.device("cuda"), ppi_graph)
    for path in PATHS:
        with rgat_branch(rs, path.rgat_fused), forced_gate(rs, layers,
                                                            path.gate):
            reference_phase(torch, rs, path)
    # PPI: one 400-node graph of PPI's degree; RGCN also on its K5 branch,
    # which the headline's "pallas" run takes. Citation: the Pubmed batch.
    task, batch = first_batch(12500, "VALIDATION", "PPI", ppi_small)
    for path in PPI_PATHS + (Path("PPI RGCN pallas", "RGCN", {
            "aggregation_strategy": "pallas"}),):
        reference_phase(torch, rs, path, task_name="PPI", task=task,
                        batch=batch)
    task, batch = first_batch(1, "VALIDATION", "CitationNetwork", pubmed,
                              data_kind="pubmed")
    for path in CITATION_PATHS:
        # 4 of the class defaults' 8 layers, at their width: at 8, a 1e-6
        # relative weight nudge moves GNN-FiLM's CPU loss by 2e-4 on this
        # graph, and the card's last-bit differences grow as far.
        reference_phase(torch, rs, path, task_name="CitationNetwork",
                        task=task, batch=batch,
                        overrides={"graph_num_layers": 4})
    vm_reference_phase(torch, rs, vm_small)
    shutil.rmtree(DATA_OUT)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
