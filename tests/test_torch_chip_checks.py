"""The checks that `chip_smoke.py` and `tests/test_torch_cuda.py` hold the
K10, K13, K14, K15 and K16 FiLM kernels, K1-K4, K9, K12a and K6a against
their earlier designs, K3's and K9's gather forms against their stream forms
and K4's d_gb against K2's, to, on the CPU: each accepts the kernel's
math taken in another summation order (emulated here, independently of
the checks' helpers) against the plain version's, and rejects a planted
fault: a product that drops its last term, a dx sum that stops one column
short, a zero or partial dW or d_w, an edge past e_real that is counted, a
term dropped or weighted by the wrong head, a mask one bit off, the wrong
leak, a row summed through its chunks or pairwise inside one, a fill slot
that reads a real row, a message cotangent one bf16 step off, K12a's
slices chunked from the layer's first edge, K6a's rows summed in 64-edge
chunks in place of its 8-edge runs. No kernel runs here; the faults are
planted in the emulation."""

import numpy as np
import pytest
import torch

from chip_smoke import (check_exact, check_kernel, emlp1_src_bwd_bounds,
                        film_bwd_design_check, film_design_check, film_terms,
                        film_variant_check, hand_kernel_names, hand_kernel_of,
                        head_dw_check, kernel_order_products, masked_terms,
                        seam_rows, segsum_t_design_check, slices_design_check,
                        src_gather_check, src_terms,
                        typed_dense_agg_bounds,
                        typed_dense_agg_bwd_check)
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.ops.graph import SD_FILL

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
