"""The checks that `chip_smoke.py` and `tests/test_torch_cuda.py` hold the
K10 and K14 kernels to, on the CPU: each accepts the kernel's math taken in
the kernel's own summation order (emulated here, independently of the
checks' helpers) against the plain version's, and rejects a planted fault:
a product that drops its last term, a dx sum that stops one column short,
a zero or partial dW, an edge past e_real that is counted. No kernel runs
here; the faults are planted in the emulation."""

import numpy as np
import pytest
import torch

from chip_smoke import (check_kernel, emlp1_src_bwd_bounds,
                        kernel_order_products, typed_dense_agg_bounds,
                        typed_dense_agg_bwd_check)
from tf_gnn_samples_torch.ops import ranked_segment as rs

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


def test_kernel_order_products_sum_in_index_order():
    """Three terms whose f32 sum depends on the order: 2^24 + 1 - 2^24 is 0
    in index order (the 1 is lost to the first add), 2^24 - 2^24 + 1 is 1."""
    a = torch.tensor([[2.0 ** 24, 1.0, -(2.0 ** 24)]]).to(torch.bfloat16)
    w = torch.ones((1, 3, 1), dtype=torch.bfloat16)
    types = torch.zeros(1, dtype=torch.int32)
    assert float(kernel_order_products(torch, a, w, types)) == 0.0
    assert float(kernel_order_products(
        torch, a[:, [0, 2, 1]], w, types)) == 1.0
