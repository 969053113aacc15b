"""The checks that `chip_smoke.py` and `tests/test_torch_cuda.py` hold the
K10, K13, K14, K15 and K16 FiLM kernels, K10's and K14's earlier bodies,
K1-K4, K9, K12a, K6a and K15a against their earlier designs, K3's and
K9's gather forms against their stream forms and K4's d_gb against K2's,
to, on the CPU: each accepts the kernel's math taken in another
summation order (emulated here, independently of the checks' helpers;
K10's and K14's on the tensor cores: 16-product k-steps truncated into
an f32 accumulator) against the plain version's, and rejects a planted
fault: a product that drops its last term, a dx sum that stops one
column short, a zero or partial dW or d_w, one edge's product taken with
another type's weights, an edge past e_real that is counted, an edge
dropped, a term one bf16 step past its order-free interval, a
term dropped or weighted by the wrong head, a mask one bit off, the wrong
leak, a row summed through its chunks or pairwise inside one, a fill slot
that reads a real row, a message cotangent one bf16 step off, K12a's
slices chunked from the layer's first edge, K6a's rows summed in 64-edge
chunks in place of its 8-edge runs. The cache, PPI, headline and
citation phases run at a tiny width with the card's launches emulated
per batch, and reject a cache that re-packs every epoch, a resume that
drops the slots, a step that launches one kernel more or another
branch's kernels, a metric line the bench regex cannot read, a loss that
is not finite and a headline run whose batches were not cached; the
VarMisuse phase also a streamed fold loaded in memory and a batch on a
branch without hand kernels, and its scan phase a scan that drops an
edge type and a "scan" that takes a kernel branch; the card-against-CPU comparison
rejects a loss or a gradient off. No kernel
runs here; the faults are planted in the emulation."""

import gzip
import itertools
import multiprocessing
import os

import numpy as np
import pytest
import torch

from chip_smoke import (CACHE_OVERRIDES, Path, batch_branch, cache_phase,
                        check_exact, check_kernel, chunk_span,
                        ppi_headline, reference_agrees, task_phase,
                        ACCURACY, MICRO_F1, PPI_PATHS,
                        emlp1_src_bwd_bounds, emlp1_src_bwd_intervals,
                        emlp1_src_bwd_tc_check, expected_launches,
                        film_bwd_design_check,
                        film_design_check, film_fwd_mask_check,
                        film_fwd_mask_design_check, film_terms,
                        film_variant_check, hand_kernel_names, hand_kernel_of,
                        head_dw_check, kernel_order_products,
                        masked_segsum_design_check, masked_segsum_table_check,
                        masked_terms, seam_rows, segsum_t_design_check,
                        slices_design_check, src_gather_check, src_terms,
                        tc_gamma, typed_dense_agg_bounds,
                        typed_dense_agg_bwd_check,
                        typed_dense_agg_bwd_tc_check,
                        typed_dense_agg_tc_check)
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.ops.graph import SD_FILL
from tf_gnn_samples_torch.runtime.model import SparseGraphModel

D = 32


def sorted_ranks(rng, e, groups):
    """Nondecreasing gap-free int32 ranks [E]."""
    _, rank = np.unique(np.sort(rng.randint(0, groups, size=e)),
                        return_inverse=True)
    return torch.from_numpy(rank.astype(np.int32))


def bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(
        np.float32)).to(torch.bfloat16)


def k10_inputs(seed=0, e=2048, types=3):
    """Receiver-sorted ranks, types (a few out of range), bf16 x, W of
    unit-scale products and the bf16 table cotangent."""
    rng = np.random.RandomState(seed)
    ranks = sorted_ranks(rng, e, 700)
    kinds = torch.from_numpy(rng.randint(0, types, size=e).astype(np.int32))
    kinds[::97] = types
    rows = int(ranks[-1]) + 1
    return (bf16(rng, e, D), bf16(rng, types, D, D, scale=D ** -0.5),
            bf16(rng, rows, D), kinds, ranks, rows)


def k10_emulated(fault, x, w, g16, types, ranks, rows, act):
    """K10a's table and K10b's (dx, dW) as the kernels form them (products
    in index order, dW summed in yet another order), with `fault`
    planted."""
    fn, dact = rs._ACTS[act]
    xk, wk = ((x[:, :-1], w[:, :-1]) if fault == "product_drops_last_term"
              else (x, w))
    y = kernel_order_products(torch, xk, wk, types)
    table = torch.zeros((rows, w.shape[2]), device=x.device).index_add_(
        0, ranks, rs._bf16_terms(fn(y)))
    valid = ((types >= 0) & (types < w.shape[0]))[:, None]
    dz = torch.where(valid, dact(y) * g16.index_select(0, ranks).float(),
                     0.0).to(torch.bfloat16)
    wt = w.transpose(1, 2)
    if fault == "dx_drops_last_term":
        dx = kernel_order_products(torch, dz[:, :-1], wt[:, :-1], types)
    else:
        dx = kernel_order_products(torch, dz, wt, types)
    dw = torch.zeros(w.shape, device=x.device)
    first = 128 if fault == "dw_drops_block" else 0
    for l in range(w.shape[0]):
        sel = (types[first:] == l).nonzero(as_tuple=True)[0] + first
        # The edges in reverse: another order than the plain version's.
        sel = sel.flip(0)
        dw[l] = x.index_select(0, sel).float().t() @ dz.index_select(
            0, sel).float()
    if fault == "dw_zero":
        dw.zero_()
    return table, (dx.to(torch.bfloat16), dw)


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("fault", ["none", "product_drops_last_term",
                                   "dx_drops_last_term", "dw_zero",
                                   "dw_drops_block"])
def test_k10_checks_accept_the_kernel_order_and_reject_planted_faults(
        fault, act):
    x, w, g16, types, ranks, rows = k10_inputs()
    table, grads = k10_emulated(fault, x, w, g16, types, ranks, rows, act)

    def fwd():
        abs_sums, counts, slack = typed_dense_agg_bounds(
            torch, rs, x, w, types, ranks, rows, act)
        check_kernel("typed_dense_agg", table,
                     rs._typed_dense_agg_plain(x, w, types, ranks, rows, act),
                     abs_sums, counts, torch, slack=slack)

    def bwd():
        typed_dense_agg_bwd_check(
            torch, rs, grads,
            rs._typed_dense_agg_bwd_plain(x, w, g16, types, ranks, act),
            x, w, g16, types, ranks, act)

    for check, planted in ((fwd, fault == "product_drops_last_term"),
                           (bwd, fault != "none")):
        if planted:
            with pytest.raises(AssertionError):
                check()
        else:
            check()


def rz_f32(v):
    """f64 values rounded toward zero to f32 (as f64)."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)),
                       f).double()


def tc_order_products(a, w, types, k_step=16):
    """y[e] = a_e @ w[type_e], f32 [E, D_out], summed as the tensor cores
    sum it: each k-step's `k_step` exact products added to the f32
    accumulator and the sum truncated toward zero; 0 for an edge of no
    type."""
    y = torch.zeros((a.shape[0], w.shape[2]), device=a.device)
    for l in range(w.shape[0]):
        sel = (types == l).nonzero(as_tuple=True)[0]
        if not sel.numel():
            continue
        al, wl = a.index_select(0, sel).double(), w[l].double()
        acc = torch.zeros((sel.numel(), w.shape[2]), dtype=torch.float64,
                          device=a.device)
        for k0 in range(0, w.shape[1], k_step):
            acc = rz_f32(acc + al[:, k0:k0 + k_step] @ wl[k0:k0 + k_step])
        y.index_copy_(0, sel, acc.float())
    return y


def k10_tc_emulated(fault, x, w, g16, types, ranks, rows, act, k_step=16):
    """K10a's table and K10b's (dx, dW) as the tensor-core kernels form
    them (tc_order_products; dW over 16-edge k-steps of each type's edges,
    the table summed in reverse stream order), with `fault` planted."""
    fn, dact = rs._ACTS[act]
    n_types = w.shape[0]
    xk, wk, kinds = x, w, types
    if fault == "product_drops_last_term":
        xk, wk = x[:, :-1], w[:, :-1]
    if fault == "wrong_type_weight":
        kinds = types.clone()
        e = int(((types >= 0) & (types < n_types)).nonzero()[0])
        kinds[e] = (types[e] + 1) % n_types
    y = tc_order_products(xk, wk, kinds, k_step)
    table = torch.zeros((rows, w.shape[2]), device=x.device).index_add_(
        0, ranks.flip(0), rs._bf16_terms(fn(y)).flip(0))
    valid = ((kinds >= 0) & (kinds < n_types))[:, None]
    dz = torch.where(valid, dact(y) * g16.index_select(0, ranks).float(),
                     0.0).to(torch.bfloat16)
    wt = w.transpose(1, 2)
    if fault == "dx_drops_last_term":
        dx = tc_order_products(dz[:, :-1], wt[:, :-1], kinds, k_step)
    else:
        dx = tc_order_products(dz, wt, kinds, k_step)
    dw = torch.zeros(w.shape, device=x.device)
    first = 128 if fault == "dw_drops_block" else 0
    for l in range(n_types):
        sel = (kinds[first:] == l).nonzero(as_tuple=True)[0] + first
        xl, zl = x.index_select(0, sel).double(), dz.index_select(
            0, sel).double()
        acc = torch.zeros(w.shape[1:], dtype=torch.float64, device=x.device)
        for k0 in range(0, sel.numel(), 16):
            acc = rz_f32(acc + xl[k0:k0 + 16].t() @ zl[k0:k0 + 16])
        dw[l] = acc.float()
    if fault == "dw_zero":
        dw.zero_()
    return table, (dx.to(torch.bfloat16), dw)


def k10_tc_checks(table, grads, x, w, g16, types, ranks, rows, act):
    """The order-free checks of K10a and K10b on an emulated output."""
    def fwd():
        typed_dense_agg_tc_check(
            torch, rs, table,
            rs._typed_dense_agg_plain(x, w, types, ranks, rows, act),
            x, w, types, ranks, rows, act)

    def bwd():
        typed_dense_agg_bwd_tc_check(
            torch, rs, grads,
            rs._typed_dense_agg_bwd_plain(x, w, g16, types, ranks, act),
            x, w, g16, types, ranks, act)

    return fwd, bwd


@pytest.mark.parametrize("act", ["relu", "gelu", "tanh"])
@pytest.mark.parametrize("fault", ["none", "product_drops_last_term",
                                   "dx_drops_last_term", "dw_zero",
                                   "dw_drops_block", "wrong_type_weight"])
def test_k10_tc_checks_accept_a_tensor_core_order_and_reject_planted_faults(
        fault, act):
    x, w, g16, types, ranks, rows = k10_inputs()
    table, grads = k10_tc_emulated(fault, x, w, g16, types, ranks, rows, act)
    fwd, bwd = k10_tc_checks(table, grads, x, w, g16, types, ranks, rows,
                             act)
    for check, planted in ((fwd, fault in ("product_drops_last_term",
                                           "wrong_type_weight")),
                           (bwd, fault != "none")):
        if planted:
            with pytest.raises(AssertionError):
                check()
        else:
            check()


@pytest.mark.parametrize("act", ["relu", "elu", "gelu"])
@pytest.mark.parametrize("order", ["index", "k_step 8", "k_step 32"])
def test_k10_tc_checks_take_any_summation_order(order, act):
    """The order-free checks also take the earlier bodies' index order and
    tensor cores that add 8 or 32 products a step."""
    x, w, g16, types, ranks, rows = k10_inputs(seed=3)
    if order == "index":
        table, grads = k10_emulated("none", x, w, g16, types, ranks, rows,
                                    act)
    else:
        table, grads = k10_tc_emulated("none", x, w, g16, types, ranks, rows,
                                       act, k_step=int(order.split()[1]))
    for check in k10_tc_checks(table, grads, x, w, g16, types, ranks, rows,
                               act):
        check()


def test_tensor_core_order_truncates_within_the_stated_unit():
    """The emulated tensor-core sums differ from round-to-nearest ones and
    stay within tc_gamma(K) sum |a_k b_k| of the exact product."""
    x, w, _, types, _, _ = k10_inputs(seed=4)
    y = tc_order_products(x, w, types)
    n_types = w.shape[0]
    valid = (types >= 0) & (types < n_types)
    exact = torch.zeros(y.shape, dtype=torch.float64)
    mags = torch.zeros_like(exact)
    for l in range(n_types):
        sel = (types == l).nonzero(as_tuple=True)[0]
        exact[sel] = x[sel].double() @ w[l].double()
        mags[sel] = x[sel].double().abs() @ w[l].double().abs()
    err = (y.double() - exact).abs()
    assert bool((err <= tc_gamma(w.shape[1]) * mags).all())
    assert bool((y[valid] != exact[valid].float()).any())


def k14_inputs(seed=1, e=2048, l_eff=3):
    """Src-sorted ranks, the t table and each rank's compact type (-1 for
    some: a self-loop type), the bf16 beta | g stream, the weights and a
    real-edge count short of the stream."""
    rng = np.random.RandomState(seed)
    ranks = sorted_ranks(rng, e, 900)
    rows = int(ranks[-1]) + 1
    cols = torch.from_numpy(rng.randint(-1, l_eff, size=rows).astype(
        np.int32))
    return (bf16(rng, e, 2 * D), bf16(rng, rows, D), cols,
            bf16(rng, l_eff, D, D, scale=D ** -0.5),
            torch.tensor([e - 100], dtype=torch.int32), ranks, rows)


def k14_emulated(fault, gcb, t, cols, w, e_real, ranks, rows, act):
    """K14's src-rank table as the kernel forms it, with `fault` planted."""
    d, e = t.shape[1], ranks.shape[0]
    c = cols.index_select(0, ranks.long())
    g = gcb.float()
    x = rs._elu(t.index_select(0, ranks).float() + g[:, :d])
    x16, wk = x.to(torch.bfloat16), w
    if fault == "product_drops_last_term":
        x16, wk = x16[:, :-1], w[:, :-1]
    y = kernel_order_products(torch, x16, wk, c)
    da = torch.where((c >= 0)[:, None], rs._ACTS[act][1](y) * g[:, d:],
                     0.0).to(torch.bfloat16)
    wt = w.transpose(1, 2)
    if fault == "dx_drops_last_term":
        dx = kernel_order_products(torch, da[:, :-1], wt[:, :-1], c)
    else:
        dx = kernel_order_products(torch, da, wt, c)
    n_live = e if fault == "tail_counted" else int(e_real)
    live = ((torch.arange(e, device=c.device) < n_live) & (c >= 0))[:, None]
    terms = rs._bf16_terms(torch.where(
        live, rs._ACTS_FROM_OUT["elu"](x) * dx, 0.0))
    return torch.zeros((rows, d), device=c.device).index_add_(0, ranks,
                                                              terms)


@pytest.mark.parametrize("fault", ["none", "product_drops_last_term",
                                   "dx_drops_last_term", "tail_counted"])
def test_k14_check_accepts_the_kernel_order_and_rejects_planted_faults(
        fault):
    gcb, t, cols, w, e_real, ranks, rows = k14_inputs()
    got = k14_emulated(fault, gcb, t, cols, w, e_real, ranks, rows, "gelu")
    abs_sums, counts, slack = emlp1_src_bwd_bounds(
        torch, rs, gcb, t, cols, w, e_real, ranks, rows, "gelu")
    want = rs._emlp1_src_bwd_plain(gcb, t, cols, w, e_real, ranks, rows,
                                   "gelu")

    def check():
        check_kernel("emlp1_src_bwd", got, want, abs_sums, counts, torch,
                     slack=slack)

    if fault == "none":
        check()
    else:
        with pytest.raises(AssertionError):
            check()


def k14_tc_emulated(fault, gcb, t, cols, w, e_real, ranks, rows, act,
                    k_step=16):
    """K14's src-rank table as the tensor-core kernel forms it (both
    products by tc_order_products, the table summed in reverse stream
    order), with `fault` planted: a term one bf16 step past its interval's
    upper end, a live edge dropped, the
    padded tail counted, a product that drops its last term, one edge's
    products taken with another type's weights, a dx sum one column short,
    one edge's dx (alone) taken with another type's weights."""
    d, e = t.shape[1], ranks.shape[0]
    n_types = w.shape[0]
    c = cols.index_select(0, ranks.long())
    n_live = e if fault == "tail_counted" else int(e_real)
    kinds = torch.where(torch.arange(e, device=c.device) < n_live, c, -1)
    valid = (kinds >= 0) & (kinds < n_types)
    if fault == "wrong_type_weight":
        first = int(valid.nonzero()[0])
        kinds = kinds.clone()
        kinds[first] = (kinds[first] + 1) % n_types
    g = gcb.float()
    x = rs._elu(t.index_select(0, ranks).float() + g[:, :d])
    x16, wk = x.to(torch.bfloat16), w
    if fault == "product_drops_last_term":
        x16, wk = x16[:, :-1], w[:, :-1]
    y = tc_order_products(x16, wk, kinds, k_step)
    da = torch.where(valid[:, None], rs._ACTS[act][1](y) * g[:, d:],
                     0.0).to(torch.bfloat16)
    da16, wt, dx_kinds = da, w.transpose(1, 2), kinds
    if fault == "dx_drops_last_term":
        da16, wt = da[:, :-1], wt[:, :-1]
    if fault == "dx_wrong_type_weight":
        first = int(valid.nonzero()[0])
        dx_kinds = kinds.clone()
        dx_kinds[first] = (kinds[first] + 1) % n_types
    dx = tc_order_products(da16, wt, dx_kinds, k_step)
    terms = rs._bf16_terms(torch.where(
        valid[:, None], rs._ACTS_FROM_OUT["elu"](x) * dx, 0.0))
    if fault == "edge_dropped":
        terms[int(valid.nonzero()[len(valid.nonzero()) // 2])] = 0.0
    if fault == "term_one_ulp_past":
        # The largest term whose row's terms in its column each have one
        # value they may take (so the row sums exactly those), one bf16
        # step past it.
        _, _, tlo, thi = emlp1_src_bwd_intervals(torch, rs, gcb, t, cols, w,
                                                 e_real, ranks, act)
        loose = torch.zeros((rows, d), device=c.device).index_add_(
            0, ranks, (tlo != thi).float())
        pinned = (loose.index_select(0, ranks) == 0) & valid[:, None]
        e0, k = divmod(int(torch.where(pinned, thi.abs(), -1.0).argmax()), d)
        bits = thi[e0, k].float().to(torch.bfloat16).view(torch.int16) + 1
        terms[e0, k] = bits.view(torch.bfloat16).float()
    return torch.zeros((rows, d), device=c.device).index_add_(
        0, ranks.flip(0), terms.flip(0))


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("fault", ["none", "term_one_ulp_past",
                                   "edge_dropped", "tail_counted",
                                   "product_drops_last_term",
                                   "wrong_type_weight", "dx_drops_last_term",
                                   "dx_wrong_type_weight"])
def test_k14_tc_check_accepts_a_tensor_core_order_and_rejects_planted_faults(
        fault, act):
    gcb, t, cols, w, e_real, ranks, rows = k14_inputs()
    got = k14_tc_emulated(fault, gcb, t, cols, w, e_real, ranks, rows, act)
    want = rs._emlp1_src_bwd_plain(gcb, t, cols, w, e_real, ranks, rows, act)

    def check():
        emlp1_src_bwd_tc_check(torch, rs, got, want, gcb, t, cols, w, e_real,
                               ranks, rows, act)

    if fault == "none":
        check()
    else:
        with pytest.raises(AssertionError):
            check()


@pytest.mark.parametrize("order", ["index", "k_step 8", "k_step 32"])
def test_k14_tc_check_takes_any_summation_order(order):
    """The order-free check also takes the earlier body's index order and
    tensor cores that add 8 or 32 products a step, and the plain
    version's output."""
    gcb, t, cols, w, e_real, ranks, rows = k14_inputs(seed=5)
    if order == "index":
        got = k14_emulated("none", gcb, t, cols, w, e_real, ranks, rows,
                           "gelu")
    else:
        got = k14_tc_emulated("none", gcb, t, cols, w, e_real, ranks, rows,
                              "gelu", k_step=int(order.split()[1]))
    want = rs._emlp1_src_bwd_plain(gcb, t, cols, w, e_real, ranks, rows,
                                   "gelu")
    emlp1_src_bwd_tc_check(torch, rs, got, want, gcb, t, cols, w, e_real,
                           ranks, rows, "gelu")
    emlp1_src_bwd_tc_check(torch, rs, want, want, gcb, t, cols, w, e_real,
                           ranks, rows, "gelu")


def test_kernel_order_products_sum_in_index_order():
    """Three terms whose f32 sum depends on the order: 2^24 + 1 - 2^24 is 0
    in index order (the 1 is lost to the first add), 2^24 - 2^24 + 1 is 1."""
    a = torch.tensor([[2.0 ** 24, 1.0, -(2.0 ** 24)]]).to(torch.bfloat16)
    w = torch.ones((1, 3, 1), dtype=torch.bfloat16)
    types = torch.zeros(1, dtype=torch.int32)
    assert float(kernel_order_products(torch, a, w, types)) == 0.0
    assert float(kernel_order_products(
        torch, a[:, [0, 2, 1]], w, types)) == 1.0


# ---- K13 and K15 ---------------------------------------------------------

def reversed_segsum(terms, ranks, rows):
    """f32 per-rank sums of `terms` in reverse stream order: another order
    than the plain versions' index_add_, as the kernels' chunked walk is."""
    return torch.zeros((rows, terms.shape[1])).index_add_(
        0, ranks.flip(0), terms.flip(0))


def order_bound(terms, ranks, rows):
    """(sum of |term|, number of terms) per row, for check_kernel."""
    return (torch.zeros((rows, terms.shape[1])).index_add_(0, ranks,
                                                           terms.abs()),
            torch.zeros(rows).index_add_(0, ranks, torch.ones(len(ranks))))


def k13_inputs(seed=2, e=2048, k=4):
    """Receiver-sorted ranks, a bf16 stream, row-major [E, K] weights and
    the bf16 table cotangent."""
    rng = np.random.RandomState(seed)
    ranks = sorted_ranks(rng, e, 500)
    rows = int(ranks[-1]) + 1
    w = torch.from_numpy(rng.rand(e, k).astype(np.float32))
    return bf16(rng, e, D), w, bf16(rng, rows, D), ranks, rows


@pytest.mark.parametrize("fault", ["none", "term_dropped", "wrong_head"])
def test_k13a_check_rejects_planted_faults(fault):
    msgs, w, _, ranks, rows = k13_inputs()
    wk = w.roll(1, dims=1) if fault == "wrong_head" else w
    terms = rs._bf16_terms(msgs.float() * rs._head_replicate(wk.t(), D))
    if fault == "term_dropped":
        terms[1000] = 0.0
    got = reversed_segsum(terms, ranks, rows)
    want = rs._wseg_plain(msgs, w, ranks, rows)
    bound = order_bound(rs._bf16_terms(
        msgs.float() * rs._head_replicate(w.t(), D)), ranks, rows)
    if fault == "none":
        check_kernel("wseg", got, want, *bound, torch)
    else:
        with pytest.raises(AssertionError):
            check_kernel("wseg", got, want, *bound, torch)


@pytest.mark.parametrize("fault", ["none", "dw_zero", "dw_drops_last_column",
                                   "dmsg_one_ulp_off"])
def test_k13b_checks_reject_planted_faults(fault):
    msgs, w, g16, ranks, rows = k13_inputs(seed=3)
    k = w.shape[1]
    g_e = g16.index_select(0, ranks)
    prods = (msgs.float() * g_e.float()).reshape(len(ranks), k, -1)
    if fault == "dw_drops_last_column":
        prods = prods[:, :, :-1]
    dw = prods.flip(2).sum(-1)  # the head's columns in reverse order
    if fault == "dw_zero":
        dw = torch.zeros_like(dw)
    dm = (g_e.float() * rs._head_replicate(w.t(), D)).to(torch.bfloat16)
    if fault == "dmsg_one_ulp_off":
        dm.view(torch.int16)[5, 3] += 1
    dm_want, dw_want = rs._wseg_bwd_plain(msgs, w, g16, ranks)

    def check():
        check_exact("wseg_bwd d_msgs", dm, dm_want, torch)
        head_dw_check("wseg_bwd d_w", dw, dw_want, msgs, g_e, torch)

    if fault == "none":
        check()
    else:
        with pytest.raises(AssertionError):
            check()


def k15_inputs(seed=4, e=2048):
    """Src-sorted-like ranks, a packed mask from K15a's plain version (both
    signs of z) and a bf16 C stream."""
    rng = np.random.RandomState(seed)
    ranks = sorted_ranks(rng, e, 600)
    rows = int(ranks[-1]) + 1
    _, mask = rs._film_fwd_mask_plain(bf16(rng, e, D), bf16(rng, rows, 2 * D),
                                      ranks, "relu")
    return mask, bf16(rng, e, D), ranks, rows


@pytest.mark.parametrize("leak", [0.0, 0.2])
@pytest.mark.parametrize("fault", ["none", "mask_one_bit_off", "wrong_leak",
                                   "term_dropped"])
def test_k15b_check_rejects_planted_faults(fault, leak):
    mask, c, ranks, rows = k15_inputs()
    used = mask.clone()
    if fault == "mask_one_bit_off":
        used[10, 1] = float(int(used[10, 1]) ^ 4)
    used_leak = (0.2 - leak) if fault == "wrong_leak" else leak
    terms = masked_terms(torch, rs, used, c, used_leak)
    if fault == "term_dropped":
        terms[77] = 0.0
    got = reversed_segsum(terms, ranks, rows)
    want = rs._masked_segsum_plain(mask, c, ranks, rows, leak)
    bound = order_bound(masked_terms(torch, rs, mask, c, leak), ranks, rows)
    if fault == "none":
        check_kernel("masked_segsum", got, want, *bound, torch)
    else:
        with pytest.raises(AssertionError):
            check_kernel("masked_segsum", got, want, *bound, torch)


def test_k15a_mask_check_rejects_one_bit_off():
    mask, _, _, _ = k15_inputs(seed=5)
    check_exact("film_fwd_mask mask", mask.clone(), mask, torch)
    off = mask.clone()
    off[3, 0] = float(int(off[3, 0]) ^ 1)
    with pytest.raises(AssertionError):
        check_exact("film_fwd_mask mask", off, mask, torch)


@pytest.mark.parametrize("fault", ["none", "mask_one_bit_flipped",
                                   "table_straight_through_chunks",
                                   "table_term_dropped"])
def test_k15a_checks_reject_planted_faults(fault):
    """K15a's check against the plain version and K1's table
    (film_fwd_mask_check) and against its earlier body
    (film_fwd_mask_design_check): an emulated kernel (K1's chunk order,
    the partials met in reverse; the plain version's mask) passes both;
    a mask with one bit flipped, a table whose two-chunk rows are summed
    straight through, or one term dropped fails. Messages over 2^-12 ..
    2^12 and runs of 5-30 edges, as the K1 design check's test."""
    rng = np.random.RandomState(9)
    sizes = rng.randint(5, 30, size=120)
    ranks = torch.from_numpy(np.repeat(np.arange(120, dtype=np.int32),
                                       sizes))
    rows = 121
    msgs = (bf16(rng, len(ranks), D).float() * torch.from_numpy(
        2.0 ** rng.randint(-12, 13, size=(len(ranks), D)))).to(torch.bfloat16)
    gb = bf16(rng, rows, 2 * D)
    want = rs._film_fwd_mask_plain(msgs, gb, ranks, "relu")
    terms = film_terms(torch, rs, msgs, gb, ranks, "relu")
    k1 = chunk_order_sums(terms, ranks, rows)
    if fault == "table_term_dropped":
        terms = terms.clone()
        terms[100] = 0.0
    table = chunk_order_sums(
        terms, ranks, rows,
        "straight" if fault == "table_straight_through_chunks" else "none",
        reverse=True)
    mask = want[1].clone()
    if fault == "mask_one_bit_flipped":
        mask[5, 1] = float(int(mask[5, 1]) ^ 8)

    def checks():
        film_fwd_mask_check(torch, rs, (table, mask), want, k1, msgs, gb,
                            ranks, "relu")
        film_fwd_mask_design_check(torch, "film_fwd_mask", (table, mask),
                                   (k1, want[1]), ranks)

    if fault == "none":
        checks()
    else:
        with pytest.raises(AssertionError):
            checks()


def k15b_emulated(terms, ranks, rows, fault="none"):
    """K15b's two kernels (csrc/masked_segsum.cu) on its per-edge f32 terms,
    into a table pre-filled with NaN: each 64-edge chunk's rank runs summed
    in stream order from 0; a run inside the chunk stored to its row, one
    that continues from the previous chunk or into the next stored as the
    chunk's lead or trail partial; the rows between neighbouring ranks,
    before the first and after the last stored as 0; then each row that
    crosses a chunk end = the trail partial of the chunk where it starts
    plus the following chunks' lead partials, in chunk order. Planted
    faults: "lead_dropped" (the join leaves out a row's last continuation
    partial), "straight" (a crossing row summed through its chunks as one
    run), "tail_unwritten" (the rows past the last rank left as they
    were), "reverse_join" (a row's partials added in reverse chunk
    order)."""
    e, d = terms.shape
    out = torch.full((rows, d), float("nan"))
    chunks = -(-e // 64)
    lead = torch.full((chunks, d), float("nan"))
    trail = torch.full((chunks, d), float("nan"))
    rk = ranks.tolist()
    out[:rk[0]] = 0.0
    if fault != "tail_unwritten":
        out[rk[-1] + 1:] = 0.0
    for k in range(chunks):
        e0, e1 = 64 * k, min(64 * k + 64, e)
        prev = rk[e0 - 1] if e0 else -1
        continued = prev == rk[e0]
        if e0:
            out[prev + 1:rk[e0]] = 0.0
        cur, first_run, acc = rk[e0], True, torch.zeros(d)
        for i in range(e0, e1):
            if rk[i] != cur:
                if first_run and continued:
                    lead[k] = acc
                else:
                    out[cur] = acc
                out[cur + 1:rk[i]] = 0.0
                cur, first_run, acc = rk[i], False, torch.zeros(d)
            acc = acc + terms[i]
        if first_run and continued:
            lead[k] = acc
        elif e1 < e and rk[e1] == cur:
            trail[k] = acc
        else:
            out[cur] = acc
    for a in range(chunks - 1):
        r = rk[64 * a + 63]
        if rk[64 * a + 64] != r or (a and rk[64 * a - 1] == r):
            continue
        parts, j = [trail[a], lead[a + 1]], a + 1
        while j + 1 < chunks and rk[64 * (j + 1)] == r:
            j += 1
            parts.append(lead[j])
        if fault == "lead_dropped":
            parts = parts[:-1]
        elif fault == "reverse_join":
            parts = parts[::-1]
        tot = parts[0]
        for part in parts[1:]:
            tot = tot + part
        if fault == "straight":
            tot = torch.zeros(d)
            for i in range(64 * a, 64 * (j + 1)):
                if i < e and rk[i] == r:
                    tot = tot + terms[i]
        out[r] = tot
    return out


def k15b_design_inputs(seed=12):
    """Runs of 5-30 edges with some of 70-200 (rows of two to four
    chunks), from rank 2 with a gap after every tenth run, in a table 6
    rows past the last rank; a random packed mask and a bf16 C stream over
    2^-12 .. 2^12 (f32 sums of bf16 terms of one magnitude would be exact
    in any order)."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(5, 30, size=150)
    sizes[::13] = rng.randint(70, 200, size=len(sizes[::13]))
    steps = np.where(np.arange(150) % 10 == 9, 2, 1)
    ranks = torch.from_numpy(np.repeat(2 + np.cumsum(steps) - steps,
                                       sizes).astype(np.int32))
    rows = int(ranks[-1]) + 7
    e = len(ranks)
    mask = torch.zeros((e, rs._mask_lanes(D)))
    mask[:, :D // 16] = torch.from_numpy(
        rng.randint(0, 2 ** 16, size=(e, D // 16)).astype(np.float32))
    c = (bf16(rng, e, D).float() * torch.from_numpy(
        2.0 ** rng.randint(-12, 13, size=(e, D)))).to(torch.bfloat16)
    return mask, c, ranks, rows


@pytest.mark.parametrize("leak", [0.0, 0.2])
@pytest.mark.parametrize("fault", ["none", "lead_dropped", "straight",
                                   "tail_unwritten", "reverse_join",
                                   "launches_differ"])
def test_k15b_design_and_table_checks_reject_planted_faults(fault, leak):
    """K15b's checks against its earlier body (masked_segsum_design_check)
    and on whole NaN-filled tables (masked_segsum_table_check), with the
    plain version's order bound, on an emulation of the kernels. Accepted:
    the kernels' order, and a row of three or more chunks whose partials
    are added in reverse chunk order (within the bound). Rejected: a
    continuation partial dropped, a two-chunk row summed straight through
    (other bits than the earlier body's two partials), a row past the
    last rank left unwritten, and two launches that differ (the second
    one's long rows joined in reverse)."""
    mask, c, ranks, rows = k15b_design_inputs()
    terms = masked_terms(torch, rs, mask, c, leak)
    spans = chunk_span(torch, ranks, rows)
    assert int((spans == 1).sum()) > 20 and int((spans >= 2).sum()) > 3
    earlier = chunk_order_sums(terms, ranks, rows, reverse=True)
    first = k15b_emulated(terms, ranks, rows,
                          "none" if fault == "launches_differ" else fault)
    again = k15b_emulated(terms, ranks, rows, {
        "launches_differ": "reverse_join"}.get(fault, fault))

    def checks():
        masked_segsum_table_check(torch, "masked_segsum", (first, again),
                                  ranks)
        masked_segsum_design_check(torch, rs, "masked_segsum", first,
                                   earlier, mask, c, ranks, leak)
        check_kernel("masked_segsum", first,
                     rs._masked_segsum_plain(mask, c, ranks, rows, leak),
                     *order_bound(terms, ranks, rows), torch)

    if fault in ("none", "reverse_join"):
        checks()
    else:
        with pytest.raises(AssertionError):
            checks()


def test_seam_rows_marks_rows_over_three_chunks():
    """A rank over edges 60-200 spans chunks 0-3 of 64 edges; one over
    edges 50-70 spans two; single-chunk ranks are in neither."""
    ranks = torch.tensor([0] * 50 + [1] * 10 + [2] * 141 + [3] * 55,
                         dtype=torch.int32)
    rows = seam_rows(torch, ranks, 6)
    assert rows.tolist() == [False, False, True, False, False, False]
    ranks = torch.tensor([0] * 50 + [1] * 21 + [2] * 10, dtype=torch.int32)
    assert not seam_rows(torch, ranks, 3).any()


def test_hand_kernel_names_read_from_the_sources():
    """The step profile's kernel names come from the CUDA sources, and a
    profiler event is charged to the kernel it names as a whole word
    only."""
    names = hand_kernel_names()
    assert {"segsum_kernel", "masked_segsum_kernel", "wseg_kernel",
            "wseg_bwd_kernel", "film_fwd_mask_kernel"} <= names
    assert all(n.endswith("_kernel") for n in names)
    assert hand_kernel_of("void masked_segsum_kernel<0>(float const*, int)",
                          names) == "masked_segsum_kernel"
    assert hand_kernel_of(
        "void (anonymous namespace)::segsum_kernel<float>(float const*)",
        names) == "segsum_kernel"
    assert hand_kernel_of("void wseg_kernel<true>(__nv_bfloat16 const*)",
                          names) == "wseg_kernel"
    assert hand_kernel_of(
        "void at::native::vectorized_elementwise_kernel<4, ...>(int, ...)",
        names) is None


@pytest.mark.parametrize("half", ["fwd", "dgb"])
def test_film_variant_check_on_gapped_ranks(half):
    """film_variant_check, the K16 FiLM variants' check, accepts K1's /
    K2's function on a stream whose ranks have gaps, and rejects it with
    one row a term short (a rank run that loses its last edge)."""
    rng = np.random.RandomState(3)
    ranks = 2 * sorted_ranks(rng, 2048, 500)
    rows = int(ranks[-1]) + 2
    msgs = bf16(rng, 2048, D)
    table = bf16(rng, rows, (2 if half == "fwd" else 3) * D)
    plain = (rs._film_fwd_plain if half == "fwd"
             else rs._film_bwd_dgb_plain)
    want = plain(msgs, table, ranks, "elu")
    film_variant_check(torch, rs, half, want.clone(), want,
                       (msgs, table, ranks), want, "elu")
    e = int(torch.nonzero(ranks[1:] == ranks[:-1])[0])  # a 2-edge run
    short = want - plain(msgs[e:e + 1], table, ranks[e:e + 1], "elu")
    with pytest.raises(AssertionError):
        film_variant_check(torch, rs, half, short, want,
                           (msgs, table, ranks), want, "elu")


# ---- K1 / K2 against their earlier design -----------------------------------

def chunk_order_sums(terms, ranks, rows, fault="none", reverse=False,
                     edges=64):
    """f32 per-row sums of `terms` in the FiLM kernels' order: a row's
    terms in each chunk of `edges` edges (64; K6a's runs: 8) summed in
    stream order from 0, the row's chunk partials then added (in chunk
    order, or in reverse with `reverse`: atomics meet in either). Planted
    faults: "straight", a row summed through its chunks as one run;
    "tree", a pairwise sum inside a chunk."""
    out = torch.zeros((rows, terms.shape[1]))
    e = len(ranks)
    if fault == "straight":
        for r in range(rows):
            acc = torch.zeros(terms.shape[1])
            for i in torch.nonzero(ranks == r).flatten().tolist():
                acc = acc + terms[i]
            out[r] = acc
        return out
    starts = list(range(0, e, edges))
    for c0 in (starts[::-1] if reverse else starts):
        chunk = ranks[c0:c0 + edges]
        for r in torch.unique(chunk).tolist():
            part = list(terms[c0:c0 + edges][chunk == r])
            if fault == "tree":
                while len(part) > 1:
                    part = [part[i] + part[i + 1] if i + 1 < len(part)
                            else part[i] for i in range(0, len(part), 2)]
                acc = part[0]
            else:
                acc = torch.zeros(terms.shape[1])
                for t in part:
                    acc = acc + t
            out[r] = out[r] + acc
    return out


@pytest.mark.parametrize("half", ["fwd", "dgb"])
@pytest.mark.parametrize("fault", ["none", "straight", "tree"])
def test_film_design_check_takes_the_chunk_order_and_rejects_others(
        half, fault):
    """film_design_check, which holds K1 / K2 to their earlier design on
    the card, accepts the per-chunk order emulated with the partials
    added in the other order, and rejects a two-chunk row summed straight
    through and a pairwise sum inside a chunk. Runs of ~5-30 edges, so
    rows of two chunks and of many terms in one chunk both occur."""
    rng = np.random.RandomState(6)
    sizes = rng.randint(5, 30, size=120)
    ranks = torch.from_numpy(np.repeat(np.arange(120, dtype=np.int32),
                                       sizes))
    rows = 121
    # Messages over 2^-12 .. 2^12: f32 sums of bf16 terms of one magnitude
    # would be exact in any order.
    msgs = (bf16(rng, len(ranks), D).float() * torch.from_numpy(
        2.0 ** rng.randint(-12, 13, size=(len(ranks), D)))).to(torch.bfloat16)
    table = bf16(rng, rows, (2 if half == "fwd" else 3) * D)
    terms = film_terms(torch, rs, msgs, table, ranks, "elu")
    earlier = chunk_order_sums(terms, ranks, rows)
    got = chunk_order_sums(terms, ranks, rows, fault,
                           reverse=fault == "none")
    if fault == "none":
        film_design_check(torch, half, got, earlier, ranks)
    else:
        with pytest.raises(AssertionError):
            film_design_check(torch, half, got, earlier, ranks)


@pytest.mark.parametrize("fault", ["none", "straight", "tree", "chunks"])
def test_k6a_design_check_takes_the_run_order_and_rejects_others(fault):
    """segsum_t_design_check, which holds K6a's [K, rows] table to its
    earlier body, accepts each row's 8-edge runs summed in stream order
    with the runs' partials added in the other order, and rejects a row
    over two runs summed straight through, a pairwise sum inside a run and
    64-edge chunks in place of the runs. Rank runs of 1-6 edges (the sizes
    of K6a's receiver and fine rows) and a few of 9-30."""
    rng = np.random.RandomState(15)
    sizes = rng.randint(1, 7, size=150)
    sizes[::25] = rng.randint(9, 31, size=6)
    ranks = torch.from_numpy(np.repeat(np.arange(150, dtype=np.int32),
                                       sizes))
    terms = rs._bf16_terms(spread(rng, bf16(rng, len(ranks), 3)).float())
    earlier = chunk_order_sums(terms, ranks, 151, edges=8).t()
    if fault == "none":
        segsum_t_design_check(torch, "segsum_t", chunk_order_sums(
            terms, ranks, 151, reverse=True, edges=8).t(), earlier, ranks)
        return
    got = (chunk_order_sums(terms, ranks, 151) if fault == "chunks"
           else chunk_order_sums(terms, ranks, 151, fault, edges=8))
    with pytest.raises(AssertionError):
        segsum_t_design_check(torch, "segsum_t", got.t(), earlier, ranks)


# ---- K3 / K4 against their earlier designs, and their other forms -----------

def run_ranks(rng, runs=120):
    """Nondecreasing gap-free ranks of runs of 5-30 edges: rows of two
    chunks and rows of many terms in one chunk both occur."""
    sizes = rng.randint(5, 30, size=runs)
    return torch.from_numpy(np.repeat(np.arange(runs, dtype=np.int32),
                                      sizes))


def spread(rng, x):
    """x scaled by 2^-12 .. 2^12 per element: f32 sums of bf16 terms of one
    magnitude would be exact in any order."""
    return (x.float() * torch.from_numpy(
        2.0 ** rng.randint(-12, 13, size=tuple(x.shape)))).to(torch.bfloat16)


def k3_diluted_inputs(seed=7, rpad=300, t_rows=400):
    """A src stream with fill slots: each edge's fine key (about one in
    eight SD_FILL, and every key of one run, so a row no real edge feeds),
    the gamma|beta and g tables, the node table t and each src group's t
    row (some past the table: clipped)."""
    rng = np.random.RandomState(seed)
    ranks = run_ranks(rng)
    rows = int(ranks[-1]) + 2
    fine = torch.from_numpy(rng.randint(0, rpad, size=len(ranks)).astype(
        np.int32))
    fine[torch.from_numpy(rng.rand(len(ranks)) < 0.125)] = int(SD_FILL)
    fine[ranks == 3] = int(SD_FILL)
    t_index = torch.from_numpy(rng.randint(0, t_rows + 3, size=rows).astype(
        np.int32))
    return (ranks, rows, fine, bf16(rng, rpad, 2 * D), bf16(rng, rpad, D),
            spread(rng, bf16(rng, t_rows, D)), t_index)


@pytest.mark.parametrize("fault", ["none", "straight", "fill_reads_a_row"])
def test_k3_gather_check_rejects_planted_faults(fault):
    """src_gather_check, which holds K3's gather form to its stream form on
    a diluted stream, accepts the per-chunk order (partials added in the
    other order) and rejects a two-chunk row summed straight through and a
    fill slot that reads the table's last row instead of adding zero."""
    ranks, rows, fine, gb, g, t, t_index = k3_diluted_inputs()
    rpad = g.shape[0]
    gcb, t_r = rs._src_stream_inputs(gb, g, fine, t, t_index)
    terms = src_terms(torch, rs, gcb, t_r, ranks, "elu")
    stream = chunk_order_sums(terms, ranks, rows)
    fed = torch.zeros(rows, dtype=torch.bool)
    fed[ranks[fine < rpad].long()] = True
    if fault == "fill_reads_a_row":
        gcb, t_r = rs._src_stream_inputs(gb, g,
                                     fine.clamp(max=rpad - 1), t, t_index)
        terms = src_terms(torch, rs, gcb, t_r, ranks, "elu")
    got = chunk_order_sums(terms, ranks, rows,
                           "straight" if fault == "straight" else "none",
                           reverse=True)
    if fault == "none":
        src_gather_check(torch, "film_src_bwd", got, stream, ranks, fed)
    else:
        with pytest.raises(AssertionError):
            src_gather_check(torch, "film_src_bwd", got, stream, ranks, fed)


@pytest.mark.parametrize("fault", ["none", "straight", "dmsg_one_step_off"])
def test_k4_design_check_rejects_planted_faults(fault):
    """film_bwd_design_check, which holds K4 to its earlier body and its
    gamma|beta|g form to its split form, and film_design_check, which holds
    K4's d_gb to K2's: the per-chunk order passes both; a two-chunk row
    summed straight through fails both; a message cotangent one bf16 step
    off fails the first."""
    rng = np.random.RandomState(8)
    ranks = run_ranks(rng)
    rows = int(ranks[-1]) + 2
    msgs = spread(rng, bf16(rng, len(ranks), D))
    gbg = bf16(rng, rows, 3 * D)
    dm, _ = rs._film_bwd_plain(msgs, gbg, ranks, "elu")
    terms = film_terms(torch, rs, msgs, gbg, ranks, "elu")
    earlier = (dm, chunk_order_sums(terms, ranks, rows))
    got_dgb = chunk_order_sums(terms, ranks, rows,
                               "straight" if fault == "straight" else "none",
                               reverse=True)
    got_dm = dm.clone()
    if fault == "dmsg_one_step_off":
        bits = got_dm.view(torch.int16)
        bits[5, 3] += 1
    if fault == "none":
        film_bwd_design_check(torch, "film_bwd", (got_dm, got_dgb), earlier,
                              ranks)
        film_design_check(torch, "film_bwd d_gb = K2's", got_dgb, earlier[1],
                          ranks)
        return
    with pytest.raises(AssertionError):
        film_bwd_design_check(torch, "film_bwd", (got_dm, got_dgb), earlier,
                              ranks)
    if fault == "straight":
        with pytest.raises(AssertionError):
            film_design_check(torch, "film_bwd d_gb = K2's", got_dgb,
                              earlier[1], ranks)


@pytest.mark.parametrize("fault", ["none", "straight", "tree"])
def test_k3_design_check_takes_the_chunk_order_and_rejects_others(fault):
    """film_design_check as it holds K3 (both forms) to its earlier body:
    the per-chunk order passes; a row summed straight through its chunks or
    pairwise inside one fails."""
    ranks, rows, fine, gb, g, t, t_index = k3_diluted_inputs(seed=9)
    gcb, t_r = rs._src_stream_inputs(gb, g, fine, t, t_index)
    terms = src_terms(torch, rs, gcb, t_r, ranks, "relu")
    earlier = chunk_order_sums(terms, ranks, rows)
    got = chunk_order_sums(terms, ranks, rows, fault,
                           reverse=fault == "none")
    if fault == "none":
        film_design_check(torch, "film_src_bwd", got, earlier, ranks)
    else:
        with pytest.raises(AssertionError):
            film_design_check(torch, "film_src_bwd", got, earlier, ranks)


# ---- K12a over several slices, K9's gather form ------------------------------

def slices_of(rng, count=5):
    """Stream slices of 150-400 edges (no multiple of 64) whose gap-free
    rank runs of 5-30 edges take disjoint rows, one slice after the
    other: [(lo, hi)], the ranks and the table height."""
    ranks, bounds, base = [], [], 0
    for _ in range(count):
        run = run_ranks(rng, runs=rng.randint(10, 20)).numpy()
        run = run[:rng.randint(150, min(400, len(run)))]
        bounds.append((sum(len(r) for r in ranks), sum(len(r) for r in ranks)
                       + len(run)))
        ranks.append(base + run)
        base += int(run[-1]) + 1
    return bounds, torch.from_numpy(np.concatenate(ranks)), base + 2


@pytest.mark.parametrize("fault", ["none", "layer_chunks", "straight"])
def test_k12a_slices_design_check_takes_each_slices_chunks(fault):
    """slices_design_check, which holds K12a's one launch over a layer's
    slices to its earlier body (one launch a slice), accepts each slice's
    rank runs summed per 64-edge chunk counted from the slice's own first
    edge (partials added in the other order), and rejects chunks counted
    from the layer's first edge and a row summed straight through its
    chunks."""
    rng = np.random.RandomState(12)
    bounds, ranks, rows = slices_of(rng)
    msgs = spread(rng, bf16(rng, len(ranks), D))
    terms = rs._bf16_terms(rs._ACTS["gelu"][0](msgs.float()))
    parts = [ranks[lo:hi] for lo, hi in bounds]

    def per_slice(fault_="none", reverse=False):
        return sum(chunk_order_sums(terms[lo:hi], ranks[lo:hi], rows, fault_,
                                    reverse=reverse) for lo, hi in bounds)

    earlier = per_slice()
    if fault == "none":
        slices_design_check(torch, "act_agg", per_slice(reverse=True),
                            earlier, parts)
        return
    got = (chunk_order_sums(terms, ranks, rows) if fault == "layer_chunks"
           else per_slice("straight"))
    with pytest.raises(AssertionError):
        slices_design_check(torch, "act_agg", got, earlier, parts)


def k9_diluted_inputs(seed=13, rpad=300, k=4):
    """A src stream with fill slots (run_ranks; about one key in eight
    SD_FILL, every key of one run), K9's side table with a positive
    denominator and a t | lsrc table over the src ranks."""
    rng = np.random.RandomState(seed)
    ranks = run_ranks(rng)
    rows = int(ranks[-1]) + 2
    fine = torch.from_numpy(rng.randint(0, rpad, size=len(ranks)).astype(
        np.int32))
    fine[torch.from_numpy(rng.rand(len(ranks)) < 0.125)] = int(SD_FILL)
    fine[ranks == 3] = int(SD_FILL)
    side = torch.from_numpy(rng.randn(rpad, D + 3 * k).astype(np.float32))
    side[:, D + k:D + 2 * k] = torch.from_numpy(
        0.5 + 4 * rng.rand(rpad, k).astype(np.float32))
    return (ranks, rows, fine, spread(rng, side.to(torch.bfloat16)),
            spread(rng, bf16(rng, rows, D + k)), k)


@pytest.mark.parametrize("fault", ["none", "straight", "fill_reads_a_row"])
def test_k9_gather_check_rejects_planted_faults(fault):
    """src_gather_check, which holds K9's gather form to its stream form on
    a diluted stream (and film_design_check, which holds both to K9's
    earlier body), accepts the per-chunk order (partials added in the
    other order) and rejects a two-chunk row summed straight through and
    a fill slot that reads the side table's last row instead of adding
    zero."""
    ranks, rows, fine, side, t_ext, k = k9_diluted_inputs()
    rpad, e = side.shape[0], len(ranks)

    def terms_of(keys):
        return rs._rgat_src_bwd_plain(
            rs._side_rows(side, keys), t_ext.index_select(0, ranks),
            torch.arange(e, dtype=torch.int32), e, k, 50.0)

    stream = chunk_order_sums(terms_of(fine), ranks, rows)
    fed = torch.zeros(rows, dtype=torch.bool)
    fed[ranks[fine < rpad].long()] = True
    keys = fine.clamp(max=rpad - 1) if fault == "fill_reads_a_row" else fine
    got = chunk_order_sums(terms_of(keys), ranks, rows,
                           "straight" if fault == "straight" else "none",
                           reverse=True)
    if fault == "none":
        src_gather_check(torch, "rgat_src_bwd", got, stream, ranks, fed)
        film_design_check(torch, "rgat_src_bwd", got, stream, ranks)
    else:
        with pytest.raises(AssertionError):
            src_gather_check(torch, "rgat_src_bwd", got, stream, ranks, fed)


# ---- the cache phase ------------------------------------------------------

@pytest.fixture(scope="module")
def qm9_dir(tmp_path_factory):
    """A data directory with the first 120 train and 40 valid graphs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = tmp_path_factory.mktemp("qm9_cache_phase")
    for fold, count in (("train", 120), ("valid", 40)):
        with gzip.open(os.path.join(root, "data", "qm9", fold + ".jsonl.gz"),
                       "rt") as fin, \
                gzip.open(str(d / (fold + ".jsonl.gz")), "wt") as fout:
            fout.writelines(itertools.islice(fin, count))
    return str(d)


def emulate_launches(monkeypatch, extra_on_cached):
    """Count, for every step, the launches GNN-FiLM's kernels make on the
    card (`expected_launches` for one batch: the wrappers count nothing on
    CPU tensors) into a counter table of the test's own, so that no other
    test sees them; `extra_on_cached`: a step on a cached batch launches
    one K1 more."""
    monkeypatch.setattr(rs, "LAUNCHES", dict.fromkeys(rs.LAUNCHES, 0))
    real_train = SparseGraphModel._train_step
    real_eval = SparseGraphModel._eval_step

    def count(model, batch, n_bwd):
        layers = (model.params["graph_num_layers"]
                  * model.params["graph_num_timesteps_per_layer"])
        for k, n in expected_launches("GNN-FiLM", layers, 1, n_bwd).items():
            rs.LAUNCHES[k] += n
        if extra_on_cached and any(batch is b for fold in
                                   model._batch_cache.values() for b in fold):
            rs.LAUNCHES["film_fwd"] += 1

    def train_step(self, batch):
        count(self, batch, 1)
        return real_train(self, batch)

    def eval_step(self, batch):
        count(self, batch, 0)
        return real_eval(self, batch)

    monkeypatch.setattr(SparseGraphModel, "_train_step", train_step)
    monkeypatch.setattr(SparseGraphModel, "_eval_step", eval_step)


@pytest.mark.parametrize("fault", ["none", "repacks_every_epoch",
                                   "resume_drops_the_slots",
                                   "cache_changes_the_launches"])
def test_cache_phase_checks_reject_planted_faults(qm9_dir, tmp_path,
                                                  monkeypatch, fault):
    """cache_phase on the CPU at a tiny width (one layer, 16 columns,
    600-node batches) with the card's launches emulated: it passes as it
    is, and fails on a cache that re-packs every epoch, a resume that
    drops the optimizer's slots and a cache that changes the launches."""
    emulate_launches(monkeypatch, fault == "cache_changes_the_launches")
    overrides = {"graph_num_layers": 1, "hidden_size": 16,
                 "max_nodes_in_batch": 600}
    if fault == "repacks_every_epoch":
        overrides["repack_cached_every"] = 1
    if fault == "resume_drops_the_slots":
        real = SparseGraphModel.restore_training_state

        def restore(self, path):
            resumed = real(self, path)
            self.opt_state = self._optimizer.init(self._leaves())
            return resumed

        monkeypatch.setattr(SparseGraphModel, "restore_training_state",
                            restore)
    kwargs = dict(data=qm9_dir, out=str(tmp_path), device="cpu",
                  overrides=overrides, rates=False)
    assert CACHE_OVERRIDES["repack_cached_every"] == 2
    if fault == "none":
        launches = cache_phase(rs, **kwargs)
        # 4 train and 2 valid batches an epoch, 4 + 2 epochs, 1 layer
        assert launches["film_fwd"] == 6 * 6 and launches["film_bwd_dgb"] == 6 * 4
        return
    match = {"repacks_every_epoch": "TRAIN packs by epoch",
             "resume_drops_the_slots": "restored state differs",
             "cache_changes_the_launches": "launches"}[fault]
    with pytest.raises(AssertionError, match=match):
        cache_phase(rs, **kwargs)


def emulate_branch_launches(monkeypatch, fault="none"):
    """For every step, count the launches the card would make for the
    branch its batch takes (batch_branch, expected_launches) into a
    counter table of the test's own; `fault`: "extra_launch" counts one
    K5a more on each eval step, "other_branch" counts RGAT's streamed
    launches where its gate says fused."""
    from chip_smoke import expected_launches, streamed_types

    monkeypatch.setattr(rs, "LAUNCHES", dict.fromkeys(rs.LAUNCHES, 0))
    monkeypatch.setattr(rs, "FORM_LAUNCHES",
                        dict.fromkeys(rs.FORM_LAUNCHES, 0))
    real = {"train": SparseGraphModel._train_step,
            "eval": SparseGraphModel._eval_step}

    def count(model, batch, n_bwd):
        layers = (model.params["graph_num_layers"]
                  * model.params["graph_num_timesteps_per_layer"])
        branch = batch_branch(rs, model, batch.graph)
        if fault == "other_branch" and branch == "RGAT-fused":
            branch = "RGAT-streamed"
        want = expected_launches(branch, layers, 1, n_bwd,
                                 streamed_types(batch.graph))
        for k, n in want.items():
            rs.LAUNCHES[k] += n
        rs.FORM_LAUNCHES["rgat_src_bwd gather"] += want["rgat_src_bwd"]
        if fault == "extra_launch" and not n_bwd:
            rs.LAUNCHES["segsum"] += 1

    def train_step(self, batch):
        count(self, batch, 1)
        return real["train"](self, batch)

    def eval_step(self, batch):
        count(self, batch, 0)
        return real["eval"](self, batch)

    monkeypatch.setattr(SparseGraphModel, "_train_step", train_step)
    monkeypatch.setattr(SparseGraphModel, "_eval_step", eval_step)


@pytest.fixture(scope="module")
def tiny_ppi(tmp_path_factory):
    """Synthetic PPI folds of 3 / 1 / 1 graphs of 60-119 nodes."""
    from tf_gnn_samples_torch.tools.synthetic_data import make_synthetic_ppi

    return make_synthetic_ppi(str(tmp_path_factory.mktemp("tiny_ppi")),
                              seed=0, folds={"train": 3, "valid": 1,
                                             "test": 1},
                              min_nodes=60, max_nodes=120,
                              fwd_edges_per_node=6)


TINY = {"graph_num_layers": 1, "hidden_size": 16, "max_nodes_in_batch": 200}


@pytest.mark.parametrize("fault", ["none", "extra_launch", "other_branch",
                                   "metric_line", "loss_not_finite"])
def test_ppi_phase_checks_reject_planted_faults(tiny_ppi, tmp_path,
                                                monkeypatch, fault):
    """The PPI phase (task_phase) on the CPU at a tiny width, launches
    emulated per batch: all seven families and RGCN forced onto K5 pass
    through the train and test CLIs (GNN-Edge-MLP1's type-major branch
    over PPI's two streamed edge types); over three of them (RGAT's fused
    pass, GNN-Edge-MLP1, RGCN on K5) it fails on an eval step that
    launches one kernel more, steps that launch another branch's
    kernels, a micro-F1 line run_ppi_benchs.py's regex cannot read and a
    loss that is not finite."""
    import run_ppi_benchs
    from tf_gnn_samples_torch.tasks.ppi import PPI_Task

    assert MICRO_F1.pattern == run_ppi_benchs.SCRAPE["micro_f1"].pattern
    emulate_branch_launches(monkeypatch, fault)
    if fault == "metric_line":
        monkeypatch.setattr(PPI_Task, "pretty_print_epoch_task_metrics",
                            lambda self, results, n: "Avg MicroF1: nan")
    if fault == "loss_not_finite":
        real = PPI_Task.output_apply

        def output_apply(self, *args, **kwargs):
            loss, metrics = real(self, *args, **kwargs)
            return loss * float("nan"), dict(metrics, loss=loss * float(
                "nan"))

        monkeypatch.setattr(PPI_Task, "output_apply", output_apply)
    paths = (Path("PPI RGAT", "RGAT", {}), Path("PPI GNN-Edge-MLP1",
                                                 "GNN-Edge-MLP1", {}),
             Path("PPI RGCN K5", "RGCN", {"aggregation_strategy": "pallas"}))
    kwargs = dict(out=str(tmp_path), device="cpu", overrides=TINY,
                  profile=False)
    if fault == "none":
        # All seven families through the train and test CLIs, and RGCN
        # forced onto K5.
        total, results = task_phase(rs, "PPI", tiny_ppi,
                                    PPI_PATHS + paths[2:], 2, **kwargs)
        steps = {label: {branch for _, branch, _ in r["steps"]}
                 for label, r in results.items()}
        assert steps == {"PPI GNN-FiLM": {"GNN-FiLM"},
                         "PPI GNN-Edge-MLP0": {"GNN-Edge-MLP0"},
                         "PPI GNN-Edge-MLP1": {"GNN-Edge-MLP1"},
                         "PPI RGAT": {"RGAT-fused"}, "PPI RGCN": {"none"},
                         "PPI GGNN": {"none"}, "PPI RGIN": {"RGIN"},
                         "PPI RGCN K5": {"RGCN"}}
        # Two streamed edge types (fwd and the untied backward): two K12b
        # launches a layer on each train step.
        n_train = sum(n for (step, branch, _), n in
                      results["PPI GNN-Edge-MLP1"]["steps"].items()
                      if step == "_train_step")
        assert results["PPI GNN-Edge-MLP1"]["launches"]["act_agg_bwd"] == (
            2 * n_train) > 0
        assert all(0 < r["metric"] < 1 for r in results.values())
        return
    match = {"extra_launch": "launches", "other_branch": "launches",
             "metric_line": "MicroF1", "loss_not_finite": "loss"}[fault]
    with pytest.raises(AssertionError, match=match):
        task_phase(rs, "PPI", tiny_ppi, paths, 2, **kwargs)


@pytest.mark.parametrize("fault", ["none", "not_cached"])
def test_ppi_headline_checks_reject_planted_faults(tiny_ppi, tmp_path,
                                                   monkeypatch, fault):
    """ppi_headline on the CPU at a tiny width: dense and K5 runs, their
    launches emulated, three epochs' train edges/s read from the log; it
    fails where the batches were not kept on the card."""
    emulate_branch_launches(monkeypatch)
    overrides = dict(TINY)
    if fault == "not_cached":
        overrides["cache_batches_on_device"] = False
    kwargs = dict(out=str(tmp_path), device="cpu", overrides=overrides,
                  profile=False)
    if fault == "none":
        total, rates = ppi_headline(rs, tiny_ppi, **kwargs)
        assert set(rates) == {"auto", "pallas"}
        assert all(len(v) == 2 and min(v) > 0 for v in rates.values())
        assert total["segsum"] > 0 and total["expand"] > 0
        return
    with pytest.raises(AssertionError, match="cached folds"):
        ppi_headline(rs, tiny_ppi, **kwargs)


@pytest.mark.parametrize("fault", ["none", "metric_line", "extra_launch"])
def test_citation_phase_checks_reject_planted_faults(tmp_path, monkeypatch,
                                                     fault):
    """The citation phase (task_phase) on the CPU at a tiny width on a
    small synthetic
    Planetoid graph: it passes as it is, and fails on an accuracy line
    that does not parse and an eval step that launches one kernel more."""
    from tf_gnn_samples_torch.tasks.citation import Citation_Network_Task
    from tf_gnn_samples_torch.tools.synthetic_data import (
        make_synthetic_planetoid)

    data = make_synthetic_planetoid(str(tmp_path / "pubmed"), seed=1,
                                    num_nodes=900, num_edges=1500,
                                    num_features=20, num_train=30,
                                    num_test=100)
    emulate_branch_launches(monkeypatch, fault)
    if fault == "metric_line":
        monkeypatch.setattr(Citation_Network_Task,
                            "pretty_print_epoch_task_metrics",
                            lambda self, results, n: "Acc: nan%")
    kwargs = dict(out=str(tmp_path), device="cpu", overrides=TINY,
                  task_overrides={"data_kind": "pubmed"}, metric=ACCURACY,
                  profile=False)
    paths = (Path("Pubmed GNN-FiLM", "GNN-FiLM", {}),
             Path("Pubmed RGCN", "RGCN", {}))
    if fault == "none":
        total, results = task_phase(rs, "CitationNetwork", data, paths, 3,
                                    **kwargs)
        assert total["film_fwd"] > 0
        assert all(0 <= r["metric"] <= 100 for r in results.values())
        return
    match = {"metric_line": "Acc", "extra_launch": "launches"}[fault]
    with pytest.raises(AssertionError, match=match):
        task_phase(rs, "CitationNetwork", data, paths, 3, **kwargs)


@pytest.mark.parametrize("fault", ["none", "loss_off", "gradient_off",
                                   "loss_nan"])
def test_reference_check_rejects_planted_faults(fault):
    """reference_agrees: last-bit differences pass; a loss 2 % off, one
    tensor's gradient 10 % off and a NaN loss fail."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(20, 8, generator=gen, dtype=torch.float64)
             for _ in range(3)]
    card = [g * (1 + 1e-6) for g in grads]
    loss = 3.25
    card_loss = loss * (1 + 1e-6)
    if fault == "loss_off":
        card_loss = loss * 1.02
    if fault == "gradient_off":
        card[1] = card[1] * 1.1
    if fault == "loss_nan":
        card_loss = float("nan")
    args = ("x", card_loss, card, loss, grads, 1e-6, {})
    if fault == "none":
        reference_agrees(*args)
        return
    with pytest.raises(AssertionError, match="disagree"):
        reference_agrees(*args)


# ---- the VarMisuse phase ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny_vm(tmp_path_factory):
    """Synthetic VarMisuse folds of 6 / 2 / 2 graphs of 30-59 nodes, the
    train fold in two shards (so that the streamed fold has a parse
    pool)."""
    from tf_gnn_samples_torch.tools.synthetic_data import (
        make_synthetic_varmisuse)

    return make_synthetic_varmisuse(
        str(tmp_path_factory.mktemp("tiny_vm")), seed=0,
        folds={"train": 6, "valid": 2, "test": 2}, min_nodes=30,
        max_nodes=60, per_chunk=3)


@pytest.fixture
def one_torch_thread():
    """The VarMisuse and scan phases at a tiny width run small tensors: with
    one intra-op thread a worker of the parallel test run does not
    oversubscribe the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# At the tiny batches RGCN's and GGNN's gate takes the dense matmuls;
# "pallas" keeps every family on its kernel branch, as at the tuned sizes.
VM_TINY = dict(TINY, aggregation_strategy="pallas", max_nodes_in_batch=150)


@pytest.mark.usefixtures("one_torch_thread")
def test_varmisuse_branches_of_the_seven_tuned_configs(tiny_vm, tmp_path):
    """batch_branch on a 22 / 23-type VarMisuse batch for the seven tuned
    configs (at the tiny width, "pallas" for RGCN's and GGNN's small
    batches): each answers its kernel branch, and the scan where asked."""
    from chip_smoke import VARMISUSE_PATHS, varmisuse_batch, varmisuse_params

    got = {}
    for path in VARMISUSE_PATHS:
        for scan in ("auto", "scan"):
            cls, params, task_params = varmisuse_params(
                path.model, dict(VM_TINY, typed_edge_scan=scan))
            task, batch = varmisuse_batch(
                os.path.join(tiny_vm, "graphs-valid"), 150, **task_params)
            assert batch.graph.num_edge_types == 22 + bool(
                task_params["add_self_loop_edges"])
            model = cls(params, task, "b", str(tmp_path), device="cpu")
            got[path.model, scan] = batch_branch(rs, model, batch.graph)
    rgat = got["RGAT", "auto"]
    assert rgat in ("RGAT-fused", "RGAT-streamed")
    assert got == {
        ("GNN-FiLM", "auto"): "GNN-FiLM", ("GNN-FiLM", "scan"): "GNN-FiLM",
        ("GNN-Edge-MLP0", "auto"): "GNN-Edge-MLP0",
        ("GNN-Edge-MLP0", "scan"): "none",
        ("GNN-Edge-MLP1", "auto"): "GNN-Edge-MLP1",
        ("GNN-Edge-MLP1", "scan"): "none",
        ("RGAT", "auto"): rgat, ("RGAT", "scan"): rgat,
        ("RGCN", "auto"): "RGCN", ("RGCN", "scan"): "RGCN",
        ("GGNN", "auto"): "GGNN", ("GGNN", "scan"): "GGNN",
        ("RGIN", "auto"): "RGIN", ("RGIN", "scan"): "none"}


@pytest.mark.parametrize("fault", ["none", "extra_launch", "not_streamed",
                                   "no_kernel_branch", "metric_line"])
@pytest.mark.usefixtures("one_torch_thread")
def test_varmisuse_phase_checks_reject_planted_faults(tiny_vm, tmp_path,
                                                      monkeypatch, fault):
    """The VarMisuse phase on the CPU at a tiny width, launches emulated
    per batch, over GNN-FiLM (its train fold streamed through its parse
    pool, which is closed after), GNN-Edge-MLP1 (its type-major branch:
    22 K12b launches a layer on each train step) and RGCN (K5) through
    the train and test CLIs, over 22 / 23 edge types, and the parse rates
    read (the seven families' branches: the test above). Over GNN-FiLM it
    fails on an eval step that launches one kernel more, a streamed fold
    that was loaded in memory, a batch on a branch without hand kernels
    and an accuracy line that run_varmisuse_benchs.py's regex cannot
    read."""
    import run_varmisuse_benchs
    from chip_smoke import (VARMISUSE_ACCURACY, VARMISUSE_PATHS, parse_rates,
                            varmisuse_phase)
    from tf_gnn_samples_torch.tasks.varmisuse import VarMisuse_Task

    assert VARMISUSE_ACCURACY.pattern == (
        run_varmisuse_benchs.SCRAPE_EVAL["testonly_acc"].pattern)
    emulate_branch_launches(monkeypatch, fault)
    overrides = dict(VM_TINY)
    if fault == "not_streamed":
        real = VarMisuse_Task.load_data

        def load_data(self, path):
            self.params["streaming_train_data"] = False
            return real(self, path)

        monkeypatch.setattr(VarMisuse_Task, "load_data", load_data)
    if fault == "no_kernel_branch":
        overrides["aggregation_strategy"] = "segment"
    if fault == "metric_line":
        monkeypatch.setattr(VarMisuse_Task, "pretty_print_epoch_task_metrics",
                            lambda self, results, n: "Accuracy: nan")
    kwargs = dict(out=str(tmp_path), device="cpu", overrides=overrides,
                  profile=False)
    if fault == "none":
        paths = tuple(p for p in VARMISUSE_PATHS if p.model in (
            "GNN-FiLM", "GNN-Edge-MLP1", "RGCN"))
        total, results = varmisuse_phase(rs, tiny_vm, paths=paths, **kwargs)
        steps = {label: {branch for _, branch, _ in r["steps"]}
                 for label, r in results.items()}
        assert steps == {"VarMisuse GNN-FiLM": {"GNN-FiLM"},
                         "VarMisuse GNN-Edge-MLP1": {"GNN-Edge-MLP1"},
                         "VarMisuse RGCN": {"RGCN"}}
        res = results["VarMisuse GNN-Edge-MLP1"]
        n_train = sum(n for (step, _, _), n in res["steps"].items()
                      if step == "_train_step")
        assert res["launches"]["act_agg_bwd"] == 22 * n_train > 0
        assert all(0 <= r["metric"] <= 1 for r in results.values())
        assert not multiprocessing.active_children()
        rates = parse_rates(tiny_vm, workers=2)
        assert set(rates) == {(0, 1), (2, 1), (2, 2)}
        assert not multiprocessing.active_children()
        return
    paths = tuple(p for p in VARMISUSE_PATHS if p.model == "GNN-FiLM")
    match = {"extra_launch": "launches", "not_streamed": "streamed",
             "no_kernel_branch": "kernel branch",
             "metric_line": "Accuracy"}[fault]
    with pytest.raises(AssertionError, match=match):
        varmisuse_phase(rs, tiny_vm, paths=paths, **kwargs)
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("fault", ["none", "scan_drops_a_type",
                                   "scan_takes_kernels"])
@pytest.mark.usefixtures("one_torch_thread")
def test_scan_phase_checks_reject_planted_faults(tiny_vm, tmp_path,
                                                 monkeypatch, fault):
    """The scan phase on the CPU at a tiny width (RGIN, GNN-Edge-MLP1 and
    RGDCN at "scan" against "unroll"): it passes as it is, and fails on a
    scan that drops one edge type's messages and on a "scan" that takes
    RGIN's kernel branch."""
    from chip_smoke import scan_phase
    from tf_gnn_samples_torch.nn import layers

    if fault == "scan_drops_a_type":
        real = layers.scan_types_aggregate

        def scan(graph, te, msgs_fn, out_dim, aggregation):
            return real(graph, te, lambda l, te_l: msgs_fn(l, te_l) * (l > 0),
                        out_dim, aggregation)

        monkeypatch.setattr(layers, "scan_types_aggregate", scan)
    if fault == "scan_takes_kernels":
        real_branch = layers.rgin_branch

        def rgin_branch(graph, **kw):
            b = real_branch(graph, **kw)
            return "ranked" if b == "scanned" else b

        monkeypatch.setattr(layers, "rgin_branch", rgin_branch)
    kwargs = dict(out=str(tmp_path), device="cpu", profile=False,
                  overrides={"graph_num_layers": 1, "hidden_size": 16,
                             "max_nodes_in_batch": 150})
    if fault == "none":
        results = scan_phase(torch, rs, tiny_vm, **kwargs)
        assert {m: {k: v["branch"] for k, v in r.items()}
                for m, r in results.items()} == {
            "RGIN": {"scan": "none", "unroll": "none", "auto": "RGIN"},
            "GNN-Edge-MLP1": {"scan": "none", "unroll": "none",
                              "auto": "GNN-Edge-MLP1"},
            "RGDCN": {"scan": "none", "unroll": "none", "auto": "none"}}
        return
    match = {"scan_drops_a_type": "disagree",
             "scan_takes_kernels": "scan"}[fault]
    with pytest.raises(AssertionError, match=match):
        scan_phase(torch, rs, tiny_vm, **kwargs)
