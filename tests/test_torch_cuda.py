"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version (the FiLM kernels K1-K4 for every activation, the ranked
segment-sum for an f32 and a bf16 stream, the ranked expand exactly, the
head-major attention kernels K6, K7 and K8, K9 and K14 on an undiluted
and a diluted src stream, the GNN-Edge-MLP1 kernels K10, K11 and K12, the
row-major weighted segment-sum K13, the sign-mask kernels K15, K15b on
both streams), the wrappers' checks and launch counts, and the GNN-FiLM
(fused and normalised), RGCN, GGNN, RGAT (fused and streamed), RGIN,
GNN-Edge-MLP (type-major with and without K14, fused1, fused0, ranked)
and RGDCN (fine form) layers on the card against the CPU.

Marked `cuda`; every test skips without a GPU. This file imports no JAX,
so it runs where JAX is absent (the repository's conftest imports it):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (check_exact, check_kernel, emlp1_src_bwd_bounds,
                        head_dw_check, masked_terms, rgat_src_bwd_bounds,
                        seam_rows, typed_dense_agg_bounds,
                        typed_dense_agg_bwd_check)
from test_torch_chip_checks import k10_emulated, k14_emulated
from tf_gnn_samples_torch.nn import layers
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.ops.graph import (SD_FILL, graph_to_device,
                                            pad_graph_batch)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph(dev):
    """A random 4-type graph (plus self loops) of 3,000 nodes on the card."""
    rng = np.random.default_rng(0)
    n = 3000
    adj = [np.stack([np.arange(n)] * 2, 1).astype(np.int32)]
    for _ in range(4):
        e = int(rng.integers(2 * n, 4 * n))
        adj.append(rng.integers(0, n, size=(e, 2)).astype(np.int32))
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    g = pad_graph_batch(feats, adj, np.zeros(n, np.int32), 1)
    return graph_to_device(g, dev)


def _terms_and_counts(kernel, act, args, flat, dev):
    """Per-edge bf16 terms of a kernel (for the order bound) and the
    number of terms of each output row."""
    fn, dact = rs._ACTS[act]
    if kernel == "film_src_bwd":
        gcb, t, ranks, rows = args
        d = t.shape[1]
        m = t.float().index_select(0, ranks)
        g = gcb.float()
        terms = rs._bf16_terms(dact(g[:, :d] * m + g[:, d:2 * d]) * g[:, 2 * d:])
    else:
        msgs, table, ranks = args
        rows, d = table.shape[0], msgs.shape[1]
        v = table.float().index_select(0, ranks)
        m = msgs.float()
        z = v[:, :d] * m + v[:, d:2 * d]
        if kernel == "film_fwd":
            terms = rs._bf16_terms(fn(z))
        else:
            dz = dact(z) * v[:, 2 * d:]
            terms = torch.cat([rs._bf16_terms(m * dz), rs._bf16_terms(dz)], 1)
    abs_sums = torch.zeros((rows, terms.shape[1]), device=dev).index_add_(
        0, ranks, terms.abs())
    counts = torch.zeros(rows, device=dev).index_add_(
        0, ranks, torch.ones(ranks.shape[0], device=dev))
    return abs_sums, counts


def _inputs(kernel, flat, d, dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return (2 * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)

    e = flat.tgt_rank.shape[0]
    if kernel == "film_fwd":
        return randn(e, d), randn(flat.fine_to_flat.shape[0], 2 * d), flat.tgt_rank
    if kernel in ("film_bwd_dgb", "film_bwd"):
        return randn(e, d), randn(flat.fine_to_flat.shape[0], 3 * d), flat.tgt_rank
    rows = flat.src_from_rank.shape[0]
    return randn(e, 3 * d), randn(rows, d), flat.src_sorted_rank, rows


def _run(kernel, args, act, plain):
    if kernel == "film_fwd":
        return (rs._film_fwd_plain(*args, act) if plain
                else rs._film_fwd_impl(*args, act=act))
    if kernel == "film_bwd_dgb":
        return (rs._film_bwd_dgb_plain(*args, act) if plain
                else rs._film_bwd_dgb_impl(*args, act=act))
    if kernel == "film_bwd":
        return (rs._film_bwd_plain(*args, act) if plain
                else rs._film_bwd_impl(*args, act=act))
    gcb, t, ranks, rows = args
    return (rs._film_src_bwd_plain(gcb, t, ranks, rows, act) if plain
            else rs._film_src_bwd_impl(gcb, t, ranks, table_rows=rows, act=act))


@pytest.mark.parametrize("d", [200, 48])
@pytest.mark.parametrize("act", sorted(rs.ACT_IDS))
@pytest.mark.parametrize("kernel", ["film_fwd", "film_bwd_dgb",
                                    "film_src_bwd", "film_bwd"])
def test_kernel_matches_plain_on_card(dev, graph, kernel, act, d):
    """Kernel and plain version sum the same bf16 terms in two orders; each
    row must agree within the f32 summation-order bound (exactly for a
    single normal term; see chip_smoke.check_kernel). D = 200 spans two column passes of a 128-thread block;
    D = 48 a partly filled warp. K4 also writes the per-edge message
    cotangent, one rounded product: equal bit for bit."""
    args = _inputs(kernel, graph.flat, d, dev)
    before = rs.LAUNCHES[kernel]
    got = _run(kernel, args, act, plain=False)
    torch.cuda.synchronize()
    assert rs.LAUNCHES[kernel] == before + 1
    want = _run(kernel, args, act, plain=True)
    if kernel == "film_bwd":
        assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    abs_sums, counts = _terms_and_counts(kernel, act, args, graph.flat, dev)
    check_kernel(kernel, got, want, abs_sums, counts, torch)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev, graph):
    msgs, table, ranks = _inputs("film_fwd", graph.flat, 64, dev)
    with pytest.raises(TypeError):
        rs._film_fwd_impl(msgs.float(), table, ranks, act="elu")
    with pytest.raises(TypeError):
        rs._film_fwd_impl(msgs, table, ranks.long(), act="elu")
    with pytest.raises(ValueError):
        rs._film_fwd_impl(msgs.t().contiguous().t(), table, ranks, act="elu")
    with pytest.raises(ValueError):
        rs._film_fwd_impl(msgs, table.cpu(), ranks, act="elu")


def test_fused_layer_on_card_matches_cpu(dev, graph):
    """One GNN-FiLM layer, forward and gradients, through K1-K3 on the card
    and through the plain versions on the CPU."""
    rng = np.random.default_rng(1)
    num_types, d = graph.num_edge_types, 64
    params = {
        "W": (0.2 * rng.standard_normal((num_types, d, d))).astype(np.float32),
        "W_film": (0.2 * rng.standard_normal((num_types, d, 2 * d))).astype(
            np.float32),
        "ln": {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)},
    }
    h = rng.standard_normal((graph.n_pad, d)).astype(np.float32)
    w = rng.standard_normal((graph.n_pad, d)).astype(np.float32)
    results = []
    for device in (dev, torch.device("cpu")):
        g = graph_to_device(graph, device)
        p = {"W": torch.tensor(params["W"], device=device, requires_grad=True),
             "W_film": torch.tensor(params["W_film"], device=device,
                                    requires_grad=True),
             "ln": {k: torch.tensor(v, device=device)
                    for k, v in params["ln"].items()}}
        hh = torch.tensor(h, device=device, requires_grad=True)
        launches = dict(rs.LAUNCHES)
        out = layers.gnn_film_apply(p, g, hh, activation_function="elu")
        (out * torch.tensor(w, device=device)).sum().backward()
        if device.type == "cuda":
            assert {k: rs.LAUNCHES[k] - launches[k] for k in launches} == dict(
                {k: 0 for k in launches}, film_fwd=1, film_bwd_dgb=1,
                film_src_bwd=1)
        results.append([x.detach().cpu().numpy()
                        for x in (out, hh.grad, p["W"].grad, p["W_film"].grad)])
    for card, cpu in zip(*results):
        # f32 matmul and sum orders differ between the devices, so a few
        # streamed values round to the neighbouring bf16 number (2^-8
        # relative each); over the whole tensor that stays far below 1e-3.
        rel = np.linalg.norm(card - cpu) / np.linalg.norm(cpu)
        assert rel < 1e-3, rel


# ---- K5: the ranked segment-sum / expand pair -----------------------------

@pytest.fixture(scope="module")
def ranked_graph(dev):
    """The random graph of `graph`, with every edge block padded to a
    multiple of 2048 edges, as tasks/base.py pads them (ranked_supported)."""
    rng = np.random.default_rng(0)
    n = 3000
    adj = [np.stack([np.arange(n)] * 2, 1).astype(np.int32)]
    for _ in range(4):
        e = int(rng.integers(2 * n, 4 * n))
        adj.append(rng.integers(0, n, size=(e, 2)).astype(np.int32))
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    g = pad_graph_batch(feats, adj, np.zeros(n, np.int32), 1,
                        e_pads=[-(-a.shape[0] // 2048) * 2048 for a in adj])
    return graph_to_device(g, dev)


@pytest.mark.parametrize("d", [200, 128, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segsum_matches_plain_on_card(dev, graph, dtype, d):
    """K5a and its plain version sum the same bf16-rounded terms in two
    orders: each row within the f32 summation-order bound."""
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    gen = torch.Generator(device=dev).manual_seed(d)
    msgs = (3 * torch.randn((ranks.shape[0], d), generator=gen,
                            device=dev)).to(dtype)
    before = rs.LAUNCHES["segsum"]
    got = rs._segsum_table_impl(msgs, ranks, table_rows=rows)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["segsum"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    want = rs._segsum_plain(msgs, ranks, rows)
    terms = rs._bf16_terms(msgs)
    abs_sums = torch.zeros((rows, d), device=dev).index_add_(0, ranks,
                                                             terms.abs())
    counts = torch.zeros(rows, device=dev).index_add_(
        0, ranks, torch.ones(ranks.shape[0], device=dev))
    check_kernel("segsum", got, want, abs_sums, counts, torch)


@pytest.mark.parametrize("d,offset", [(200, 0), (128, 0), (130, 0), (128, 1)])
def test_expand_matches_plain_exactly_on_card(dev, graph, d, offset):
    """K5b rounds each table row to bf16 and copies it: exact. D = 130 and
    a table one float past an aligned address take the 4-byte path."""
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    gen = torch.Generator(device=dev).manual_seed(d)
    base = torch.randn(rows * d + offset, generator=gen, device=dev)
    table = base[offset:].view(rows, d)
    before = rs.LAUNCHES["expand"]
    got = rs._expand_impl(table, ranks)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["expand"] == before + 1
    assert torch.equal(got, rs._expand_plain(table, ranks))


def test_k5_wrappers_refuse_what_the_kernels_do_not_take(dev, graph):
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    msgs = torch.zeros((ranks.shape[0], 16), device=dev)
    table = torch.zeros((rows, 16), device=dev)
    with pytest.raises(TypeError):
        rs._segsum_table_impl(msgs.half(), ranks, table_rows=rows)
    with pytest.raises(TypeError):
        rs._segsum_table_impl(msgs, ranks.long(), table_rows=rows)
    with pytest.raises(ValueError):
        rs._segsum_table_impl(msgs, ranks.cpu(), table_rows=rows)
    with pytest.raises(TypeError):
        rs._expand_impl(table.to(torch.bfloat16), ranks)
    with pytest.raises(ValueError):
        rs._expand_impl(table.t().contiguous().t()[:, :8], ranks)


@pytest.mark.parametrize("layer", ["rgcn", "ggnn"])
def test_ranked_layer_on_card_matches_cpu(dev, ranked_graph, layer):
    """One RGCN / GGNN layer on the ranked path ("pallas"), forward and
    gradients: K5a forward and K5b backward on the card, their plain
    versions on the CPU."""
    rng = np.random.default_rng(2)
    num_types, d = ranked_graph.num_edge_types, 64
    params = {"W": (0.2 * rng.standard_normal((num_types, d, d))).astype(
        np.float32)}
    if layer == "ggnn":
        params["cell"] = {
            "kernel": (0.2 * rng.standard_normal((d, d))).astype(np.float32),
            "recurrent_kernel": (0.2 * rng.standard_normal((d, d))).astype(
                np.float32),
            "bias": np.zeros(d, np.float32)}
    kw = ({"gated_unit_type": "rnn", "activation_function": "relu"}
          if layer == "ggnn" else {"activation_function": "leaky_relu"})
    apply = getattr(layers, layer + "_apply")
    h = rng.standard_normal((ranked_graph.n_pad, d)).astype(np.float32)
    w = rng.standard_normal((ranked_graph.n_pad, d)).astype(np.float32)
    results = []
    for device in (dev, torch.device("cpu")):
        g = graph_to_device(ranked_graph, device)
        p = {"W": torch.tensor(params["W"], device=device, requires_grad=True)}
        if "cell" in params:
            p["cell"] = {k: torch.tensor(v, device=device)
                         for k, v in params["cell"].items()}
        hh = torch.tensor(h, device=device, requires_grad=True)
        launches = dict(rs.LAUNCHES)
        out = apply(p, g, hh, aggregation_strategy="pallas", **kw)
        (out * torch.tensor(w, device=device)).sum().backward()
        if device.type == "cuda":
            assert {k: rs.LAUNCHES[k] - launches[k] for k in launches} == dict(
                {k: 0 for k in launches}, segsum=1, expand=1)
        results.append([x.detach().cpu().numpy()
                        for x in (out, hh.grad, p["W"].grad)])
    for card, cpu in zip(*results):
        # As for the FiLM layer: a few streamed values round to the
        # neighbouring bf16 number on one device (2^-8 relative each).
        rel = np.linalg.norm(card - cpu) / np.linalg.norm(cpu)
        assert rel < 1e-3, rel


# ---- K6, K7: the head-major attention kernels -----------------------------

def _order_inputs(dev, ranks, rows, terms):
    """Sum of |terms| and number of terms per table row, for check_kernel."""
    abs_sums = torch.zeros((rows, terms.shape[1]), device=dev).index_add_(
        0, ranks, terms.abs())
    counts = torch.zeros(rows, device=dev).index_add_(
        0, ranks, torch.ones(ranks.shape[0], device=dev))
    return abs_sums, counts


@pytest.mark.parametrize("k", [8, 4, 3])
@pytest.mark.parametrize("which", ["rcv_rank", "tgt_rank"])
def test_segsum_t_matches_plain_on_card(dev, graph, which, k):
    """K6a and its plain version sum the same bf16-rounded terms in two
    orders: each (head, rank) entry within the f32 summation-order bound,
    on the coarse and the fine ranks (whose edge count, no multiple of a
    thread's 8-edge run, leaves a ragged last run)."""
    ranks = getattr(graph.flat, which)
    rows = int(ranks[-1]) + 9
    gen = torch.Generator(device=dev).manual_seed(k)
    m_t = 3 * torch.randn((k, ranks.shape[0]), generator=gen, device=dev)
    before = rs.LAUNCHES["segsum_t"]
    got = rs._segsum_t_impl(m_t, ranks, table_rows=rows)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["segsum_t"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (k, rows)
    want = rs._segsum_t_plain(m_t, ranks, rows)
    abs_sums, counts = _order_inputs(dev, ranks, rows,
                                     rs._bf16_terms(m_t).t())
    check_kernel("segsum_t", got.t(), want.t(), abs_sums, counts, torch)


@pytest.mark.parametrize("k", [8, 4, 3])
def test_expand_t_matches_plain_exactly_on_card(dev, graph, k):
    """K6b rounds each table entry to bf16 and copies it: exact."""
    ranks = graph.flat.tgt_rank
    rows = graph.flat.fine_to_flat.shape[0]
    gen = torch.Generator(device=dev).manual_seed(k)
    table_t = 30 * torch.randn((k, rows), generator=gen, device=dev)
    before = rs.LAUNCHES["expand_t"]
    got = rs._expand_t_impl(table_t, ranks)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["expand_t"] == before + 1
    assert got.shape == (k, ranks.shape[0])
    assert torch.equal(got, rs._expand_t_plain(table_t, ranks))


# (heads, D, extra columns): D = 200 spans two column passes of a
# 128-thread block, 48 a partly filled warp; 40 / 8 = 5 columns a head is
# no multiple of K7b's 16-byte pieces.
HEAD_CASES = [(8, 128, 0), (8, 128, 8), (4, 200, 0), (8, 48, 0), (8, 40, 0),
              (3, 48, 0), (1, 64, 0)]


@pytest.mark.parametrize("k,d,extra", HEAD_CASES)
def test_wseg_t_matches_plain_on_card(dev, graph, k, d, extra):
    """K7a and its plain version sum the same bf16-rounded products in two
    orders; the `extra` case feeds a [E, D + extra] stream with d_used."""
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    e = ranks.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d + k)
    msgs = torch.randn((e, d + extra), generator=gen, device=dev).to(
        torch.bfloat16)
    w_t = torch.rand((k, e), generator=gen, device=dev)
    d_used = d if extra else None
    before = rs.LAUNCHES["wseg_t"]
    got = rs._wseg_t_impl(msgs, w_t, ranks, table_rows=rows, num_heads=k,
                          d_used=d_used)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["wseg_t"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    want = rs._wseg_t_plain(msgs, w_t, ranks, rows, d_used)
    terms = rs._bf16_terms(msgs[:, :d].float() * rs._head_replicate(w_t, d))
    check_kernel("wseg_t", got, want,
                 *_order_inputs(dev, ranks, rows, terms), torch)


@pytest.mark.parametrize("k,d,offset", [(k, d, 0) for k, d, x in HEAD_CASES
                                        if not x] + [(8, 128, 1)])
def test_wseg_t_bwd_matches_plain_on_card(dev, graph, k, d, offset):
    """K7b: d_msgs equals the plain version's exactly (one f32 product
    rounded to bf16); d_w_t, an f32 sum of D / K exact products in another
    order, within the summation-order bound. A stream one bf16 past an
    aligned address takes the 2-byte path."""
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    e = ranks.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d * k)
    base = torch.randn(e * d + offset, generator=gen, device=dev).to(
        torch.bfloat16)
    msgs = base[offset:].view(e, d)
    w_t = torch.rand((k, e), generator=gen, device=dev)
    g16 = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    before = rs.LAUNCHES["wseg_t_bwd"]
    dm, dw = rs._wseg_t_bwd_impl(msgs, w_t, g16, ranks, num_heads=k)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["wseg_t_bwd"] == before + 1
    assert dm.dtype == torch.bfloat16 and dm.shape == (e, d)
    assert dw.dtype == torch.float32 and dw.shape == (k, e)
    dm_want, dw_want = rs._wseg_t_bwd_plain(msgs, w_t, g16, ranks)
    assert torch.equal(dm, dm_want)
    sums = (msgs.float() * g16.float().index_select(0, ranks)).abs().reshape(
        e, k, -1).sum(-1).t()
    check_kernel("wseg_t_bwd", dw.reshape(-1, 1), dw_want.reshape(-1, 1),
                 sums.reshape(-1, 1),
                 torch.full((e * k,), float(d // k), device=dev), torch)


@pytest.mark.parametrize("k,d,extra,offset",
                         [(k, d, x, 0) for k, d, x in HEAD_CASES]
                         + [(8, 128, 8, 1), (4, 64, 4, 0)])
def test_wseg_t_dw_matches_plain_on_card(dev, graph, k, d, extra, offset):
    """K8: d_w_t, an f32 sum of D / K exact products in another order than
    the plain version's, within the summation-order bound. The `extra`
    cases feed a [E, D + extra] stream with d_used = D (4 extra columns
    leave rows off 16-byte addresses, as a stream one bf16 past an aligned
    address does: the 2-byte path); the extra columns hold 1e4 and must
    not be read."""
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    e = ranks.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d * k + extra)
    base = torch.randn(e * (d + extra) + offset, generator=gen,
                       device=dev).to(torch.bfloat16)
    msgs = base[offset:].view(e, d + extra)
    msgs[:, d:] = 1e4
    g16 = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    d_used = d if extra else None
    before = rs.LAUNCHES["wseg_t_dw"]
    dw = rs._wseg_t_dw_impl(msgs, g16, ranks, num_heads=k, d_used=d_used)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["wseg_t_dw"] == before + 1
    assert dw.dtype == torch.float32 and dw.shape == (k, e)
    dw_want = rs._wseg_t_dw_plain(msgs, g16, ranks, k, d_used)
    sums = (msgs[:, :d].float() * g16.float().index_select(0, ranks)
            ).abs().reshape(e, k, -1).sum(-1).t()
    check_kernel("wseg_t_dw", dw.reshape(-1, 1), dw_want.reshape(-1, 1),
                 sums.reshape(-1, 1),
                 torch.full((e * k,), float(d // k), device=dev), torch)


@pytest.fixture(scope="module")
def diluted_graph(dev):
    """A graph of PPI-like degree (14 random in-edges per node, their
    reverses as a second type, self loops), whose src stream dilutes."""
    rng = np.random.default_rng(4)
    n = 2000
    fwd = rng.integers(0, n, size=(14 * n, 2)).astype(np.int32)
    adj = [fwd, fwd[:, ::-1].copy(),
           np.stack([np.arange(n)] * 2, 1).astype(np.int32)]
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    g = pad_graph_batch(feats, adj, np.zeros(n, np.int32), 1,
                        e_pads=[-(-a.shape[0] // 2048) * 2048 for a in adj])
    assert g.flat.win_sd and g.flat.sd_rank.shape[0] > g.flat.src_flat.shape[0]
    return graph_to_device(g, dev)


@pytest.mark.parametrize("k,d", [(8, 128), (8, 64), (4, 200), (8, 48),
                                 (3, 48), (1, 64), (16, 128)])
@pytest.mark.parametrize("stream", ["undiluted", "diluted"])
def test_rgat_src_bwd_matches_plain_on_card(dev, graph, diluted_graph,
                                            stream, k, d):
    """K9 against its plain version: the same bf16 terms up to one bf16
    ulp each (expf against torch.exp) and the cancellation slack of
    chip_smoke.rgat_src_bwd_bounds, summed in two orders. Inputs as the
    fused backward builds them: the side table's rows gathered by the fine
    key of each slot, fill keys (the diluted stream) clamped onto appended
    zero rows. Rows fed by no real edge stay exactly zero. Heads of 25, 6
    and 16 columns with 3 or 1 heads take the 2-byte loads."""
    if stream == "diluted":
        flat = diluted_graph.flat
        fine, ranks, _ = layers.src_stream(flat)
        assert fine is flat.sd_fine and bool((fine == 2 ** 31 - 1).any())
    else:
        flat = graph.flat
        fine, ranks = flat.fine_rank_by_src, flat.src_sorted_rank
    rpad, rsrc = flat.fine_to_flat.shape[0], flat.src_from_rank.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d + k)
    side = torch.randn((rpad, d + 3 * k), generator=gen, device=dev)
    side[:, d + k:d + 2 * k] = 0.5 + 4 * torch.rand((rpad, k), generator=gen,
                                                    device=dev)
    side[::37, d:d + k] = 80.0  # logits beyond the clamp
    side[int(flat.tgt_rank.max()):] = 0.0  # the dump rank, the slack rows
    gcb = rs._zero_extended(side.to(torch.bfloat16)).index_select(
        0, fine.clamp(max=rpad))
    t_ext = torch.randn((rsrc, d + k), generator=gen, device=dev).to(
        torch.bfloat16)
    before = rs.LAUNCHES["rgat_src_bwd"]
    got = rs._rgat_src_bwd_impl(gcb, t_ext, ranks, table_rows=rsrc,
                                num_heads=k, clamp=50.0)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["rgat_src_bwd"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (rsrc, d + k)
    want = rs._rgat_src_bwd_plain(gcb, t_ext, ranks, rsrc, k, 50.0)
    abs_sums, counts, slack = rgat_src_bwd_bounds(torch, rs, gcb, t_ext,
                                                  ranks, rsrc, k)
    check_kernel("rgat_src_bwd", got, want, abs_sums, counts, torch,
                 term_ulps=1, slack=slack)
    fed = torch.zeros(rsrc, device=dev).index_add_(
        0, ranks, (gcb.float().abs().sum(1) > 0).float()) > 0
    assert bool(fed.any()) and not bool(got[~fed].any())


def test_head_major_wrappers_refuse_what_the_kernels_do_not_take(dev, graph):
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    e = ranks.shape[0]
    m_t = torch.zeros((4, e), device=dev)
    msgs = torch.zeros((e, 16), device=dev, dtype=torch.bfloat16)
    g16 = torch.zeros((rows, 16), device=dev, dtype=torch.bfloat16)
    before = dict(rs.LAUNCHES)
    with pytest.raises(TypeError):
        rs._segsum_t_impl(m_t.to(torch.bfloat16), ranks, table_rows=rows)
    with pytest.raises(TypeError):
        rs._segsum_t_impl(m_t, ranks.long(), table_rows=rows)
    with pytest.raises(ValueError):
        rs._segsum_t_impl(m_t, ranks.cpu(), table_rows=rows)
    with pytest.raises(TypeError):
        rs._expand_t_impl(torch.zeros((4, rows), device=dev).half(), ranks)
    with pytest.raises(ValueError):
        rs._expand_t_impl(torch.zeros((rows, 4), device=dev).t(), ranks)
    with pytest.raises(TypeError):  # an f32 stream
        rs._wseg_t_impl(msgs.float(), m_t, ranks, table_rows=rows,
                        num_heads=4)
    with pytest.raises(TypeError):  # bf16 weights
        rs._wseg_t_impl(msgs, m_t.to(torch.bfloat16), ranks, table_rows=rows,
                        num_heads=4)
    with pytest.raises(ValueError):  # 16 columns, 3 heads
        rs._wseg_t_impl(msgs, m_t[:3].contiguous(), ranks, table_rows=rows,
                        num_heads=3)
    with pytest.raises(TypeError):  # an f32 cotangent table
        rs._wseg_t_bwd_impl(msgs, m_t, g16.float(), ranks, num_heads=4)
    with pytest.raises(ValueError):  # a cotangent table on the CPU
        rs._wseg_t_bwd_impl(msgs, m_t, g16.cpu(), ranks, num_heads=4)
    with pytest.raises(TypeError):  # an f32 stream
        rs._wseg_t_dw_impl(msgs.float(), g16, ranks, num_heads=4)
    with pytest.raises(ValueError):  # a stream that is a column slice
        rs._wseg_t_dw_impl(
            torch.zeros((e, 32), device=dev, dtype=torch.bfloat16)[:, :16],
            g16, ranks, num_heads=4)
    gcb = torch.zeros((e, 16 + 12), device=dev, dtype=torch.bfloat16)
    t_ext = torch.zeros((rows, 16 + 4), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # an f32 side stream
        rs._rgat_src_bwd_impl(gcb.float(), t_ext, ranks, table_rows=rows,
                              num_heads=4, clamp=50.0)
    with pytest.raises(TypeError):
        rs._rgat_src_bwd_impl(gcb, t_ext, ranks.long(), table_rows=rows,
                              num_heads=4, clamp=50.0)
    with pytest.raises(ValueError):  # more heads than a block's shared memory
        rs._rgat_src_bwd_impl(
            torch.zeros((e, 4 * 128), device=dev, dtype=torch.bfloat16),
            torch.zeros((rows, 2 * 128), device=dev, dtype=torch.bfloat16),
            ranks, table_rows=rows, num_heads=128, clamp=50.0)
    with pytest.raises(TypeError):  # an f32 gamma | beta | g table
        rs._film_bwd_impl(msgs, torch.zeros((rows, 48), device=dev), ranks,
                          act="elu")
    assert rs.LAUNCHES == before  # nothing refused was launched


@pytest.mark.parametrize("branch", ["streamed", "fused"])
@pytest.mark.parametrize("d,heads", [(128, 8), (64, 4)])
def test_rgat_layer_on_card_matches_cpu(dev, ranked_graph, monkeypatch, d,
                                        heads, branch):
    """One RGAT layer, forward and gradients, on the card against the
    plain versions on the CPU, on each kernel branch (the gate forced
    either way): streamed K6a, K6b, K7a, K7b and (in the message gather's
    backward) K5a; fused K6a, K6b, K7a, K8 and K9."""
    monkeypatch.setattr(rs, "rgat_fused_supported",
                        lambda *a, **k: branch == "fused")
    own = (dict(wseg_t_bwd=1, segsum=1) if branch == "streamed"
           else dict(wseg_t_dw=1, rgat_src_bwd=1))
    rng = np.random.default_rng(3)
    num_types = ranked_graph.num_edge_types
    params = {"W": (0.1 * rng.standard_normal((num_types, d, d))).astype(
        np.float32),
        "att": (0.3 * rng.standard_normal((num_types, 2 * d))).astype(
            np.float32)}
    h = rng.standard_normal((ranked_graph.n_pad, d)).astype(np.float32)
    w = rng.standard_normal((ranked_graph.n_pad, d)).astype(np.float32)
    results = []
    for device in (dev, torch.device("cpu")):
        g = graph_to_device(ranked_graph, device)
        p = {k: torch.tensor(v, device=device, requires_grad=True)
             for k, v in params.items()}
        hh = torch.tensor(h, device=device, requires_grad=True)
        launches = dict(rs.LAUNCHES)
        out = layers.rgat_apply(p, g, hh, num_heads=heads,
                                activation_function="elu")
        (out * torch.tensor(w, device=device)).sum().backward()
        if device.type == "cuda":
            assert {k: rs.LAUNCHES[k] - launches[k] for k in launches} == dict(
                {k: 0 for k in launches}, expand_t=3, segsum_t=3, wseg_t=1,
                **own)
        results.append([x.detach().cpu().numpy()
                        for x in (out, hh.grad, p["W"].grad, p["att"].grad)])
    for card, cpu in zip(*results):
        # As for the other layers: a few streamed values round to the
        # neighbouring bf16 number on one device (2^-8 relative each), and
        # the softmax denominator carries such a flip to a whole receiver.
        rel = np.linalg.norm(card - cpu) / np.linalg.norm(cpu)
        assert rel < 2e-3, rel


@pytest.mark.parametrize("which", ["ranked_graph", "diluted_graph"])
def test_film_ranked_and_diluted_layers_on_card_match_cpu(dev, request,
                                                          which):
    """One GNN-FiLM layer, forward and gradients, on the card against the
    CPU: with normalised messages (K1 forward; K4 and K5a backward), and
    without on the graph whose src stream dilutes (K1; K2 and K3 over the
    fill-extended stream)."""
    g_card = request.getfixturevalue(which)
    normalize = which == "ranked_graph"
    own = (dict(film_fwd=1, film_bwd=1, segsum=1) if normalize
           else dict(film_fwd=1, film_bwd_dgb=1, film_src_bwd=1))
    rng = np.random.default_rng(5)
    num_types, d = g_card.num_edge_types, 64
    params = {
        "W": (0.2 * rng.standard_normal((num_types, d, d))).astype(np.float32),
        "W_film": (0.2 * rng.standard_normal((num_types, d, 2 * d))).astype(
            np.float32)}
    h = rng.standard_normal((g_card.n_pad, d)).astype(np.float32)
    w = rng.standard_normal((g_card.n_pad, d)).astype(np.float32)
    results = []
    for device in (dev, torch.device("cpu")):
        g = graph_to_device(g_card, device)
        p = {k: torch.tensor(v, device=device, requires_grad=True)
             for k, v in params.items()}
        p["ln"] = {"scale": torch.ones(d, device=device),
                   "bias": torch.zeros(d, device=device)}
        hh = torch.tensor(h, device=device, requires_grad=True)
        launches = dict(rs.LAUNCHES)
        out = layers.gnn_film_apply(p, g, hh, activation_function="elu",
                                    normalize_by_num_incoming=normalize)
        (out * torch.tensor(w, device=device)).sum().backward()
        if device.type == "cuda":
            assert {k: rs.LAUNCHES[k] - launches[k] for k in launches} == dict(
                {k: 0 for k in launches}, **own)
        results.append([x.detach().cpu().numpy()
                        for x in (out, hh.grad, p["W"].grad, p["W_film"].grad)])
    for card, cpu in zip(*results):
        # As for the other layers: a few streamed values round to the
        # neighbouring bf16 number on one device (2^-8 relative each).
        rel = np.linalg.norm(card - cpu) / np.linalg.norm(cpu)
        assert rel < 1e-3, rel


# ---- K11, K12: the GNN-Edge-MLP1 kernels ----------------------------------

# (D, bf16 elements the streams start past an aligned address): D = 200 and
# 128 take the 8-column slots, D = 44 and a stream one bf16 past an aligned
# address the single columns; D = 200 also spans two column passes of a
# 128-thread block in the two reductions.
EMLP_CASES = [(128, 0), (200, 0), (44, 0), (128, 1)]


def _tm_inputs(dev, flat, d, offset, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    e = flat.tm_rank.shape[0]
    rows = flat.tm_to_flat.shape[0]

    def stream():
        base = (2 * torch.randn(e * d + offset, generator=gen,
                                device=dev)).to(torch.bfloat16)
        return base[offset:].view(e, d)

    return e, rows, stream, gen


@pytest.mark.parametrize("d,offset", EMLP_CASES)
@pytest.mark.parametrize("act", sorted(rs.ACT_IDS))
def test_expand_add_act_matches_plain_exactly_on_card(dev, ranked_graph, act,
                                                      d, offset):
    """K11a: one f32 sum and activation per element, rounded once, through
    the same expf / tanhf as the plain version's: equal bit for bit."""
    flat = ranked_graph.flat
    e, rows, stream, gen = _tm_inputs(dev, flat, d, offset, d)
    m = stream()
    beta = 2 * torch.randn((rows, d), generator=gen, device=dev)
    before = rs.LAUNCHES["expand_add_act"]
    got = rs._expand_add_act_impl(m, beta, flat.tm_rank, act=act)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["expand_add_act"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (e, d)
    assert torch.equal(got, rs._expand_add_act_plain(m, beta, flat.tm_rank,
                                                     act))


@pytest.mark.parametrize("d,offset", EMLP_CASES)
@pytest.mark.parametrize("act", sorted(rs._ACTS_FROM_OUT))
def test_expand_add_act_bwd_matches_plain_on_card(dev, ranked_graph, act, d,
                                                  offset):
    """K11b: d_m (one rounded product) equals the plain version's bit for
    bit; d_beta sums the same bf16 terms in another order."""
    flat = ranked_graph.flat
    ranks = flat.tm_rank
    e, rows, stream, _ = _tm_inputs(dev, flat, d, offset, d + 1)
    x, dx = stream(), stream()
    before = rs.LAUNCHES["expand_add_act_bwd"]
    dm, dbeta = rs._expand_add_act_bwd_impl(x, dx, ranks, table_rows=rows,
                                            act=act)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["expand_add_act_bwd"] == before + 1
    assert dm.dtype == torch.bfloat16 and dbeta.shape == (rows, d)
    dm_want, dbeta_want = rs._expand_add_act_bwd_plain(x, dx, ranks, rows, act)
    assert torch.equal(dm, dm_want)
    check_kernel("expand_add_act_bwd", dbeta, dbeta_want,
                 *_order_inputs(dev, ranks, rows, dm_want.float()), torch)


@pytest.mark.parametrize("d,offset", EMLP_CASES)
@pytest.mark.parametrize("act", sorted(rs.ACT_IDS))
def test_act_agg_matches_plain_on_card(dev, ranked_graph, act, d, offset):
    """K12a over the whole type-major stream and over each type's slice
    (ranks that start anywhere): the same bf16 terms in two orders. K12b
    (one rounded product per element) equals its plain version bit for
    bit."""
    flat = ranked_graph.flat
    e, rows, stream, gen = _tm_inputs(dev, flat, d, offset, d + 2)
    msgs = stream()
    g16 = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    offs = flat.tm_offs
    for lo, hi in [(0, e)] + list(zip(offs[:-1], offs[1:])):
        m, ranks = msgs[lo:hi], flat.tm_rank[lo:hi]
        before = dict(rs.LAUNCHES)
        got = rs._act_agg_impl(m, ranks, table_rows=rows, act=act)
        dmsg = rs._act_agg_bwd_impl(m, g16, ranks, act=act)
        torch.cuda.synchronize()
        assert {k: rs.LAUNCHES[k] - before[k] for k in before} == dict(
            {k: 0 for k in before}, act_agg=1, act_agg_bwd=1)
        assert got.dtype == torch.float32 and got.shape == (rows, d)
        terms = rs._bf16_terms(rs._ACTS[act][0](m.float()))
        check_kernel("act_agg", got, rs._act_agg_plain(m, ranks, rows, act),
                     *_order_inputs(dev, ranks, rows, terms), torch)
        assert dmsg.dtype == torch.bfloat16 and dmsg.shape == (hi - lo, d)
        assert torch.equal(dmsg, rs._act_agg_bwd_plain(m, g16, ranks, act))


def test_edge_mlp_wrappers_refuse_what_the_kernels_do_not_take(dev,
                                                               ranked_graph):
    flat = ranked_graph.flat
    ranks = flat.tm_rank
    e, rows = ranks.shape[0], flat.tm_to_flat.shape[0]
    m = torch.zeros((e, 16), device=dev, dtype=torch.bfloat16)
    beta = torch.zeros((rows, 16), device=dev)
    before = dict(rs.LAUNCHES)
    with pytest.raises(TypeError):  # an f32 stream
        rs._expand_add_act_impl(m.float(), beta, ranks, act="elu")
    with pytest.raises(TypeError):  # a bf16 table
        rs._expand_add_act_impl(m, beta.to(torch.bfloat16), ranks, act="elu")
    with pytest.raises(ValueError):  # a table on the CPU
        rs._expand_add_act_impl(m, beta.cpu(), ranks, act="elu")
    with pytest.raises(TypeError):
        rs._expand_add_act_bwd_impl(m, m.float(), ranks, table_rows=rows,
                                    act="elu")
    with pytest.raises(ValueError):  # gelu' is no function of the output
        rs._expand_add_act_bwd_impl(m, m, ranks, table_rows=rows, act="gelu")
    with pytest.raises(TypeError):
        rs._act_agg_impl(m, ranks.long(), table_rows=rows, act="gelu")
    with pytest.raises(ValueError):  # a stream that is a column slice
        rs._act_agg_impl(
            torch.zeros((e, 32), device=dev, dtype=torch.bfloat16)[:, :16],
            ranks, table_rows=rows, act="gelu")
    with pytest.raises(TypeError):  # an f32 cotangent table
        rs._act_agg_bwd_impl(m, beta, ranks, act="gelu")
    assert rs.LAUNCHES == before  # nothing refused was launched


@pytest.mark.parametrize("kind", [1, 0])
def test_edge_mlp_layer_on_card_matches_cpu(dev, ranked_graph, kind):
    """One GNN-Edge-MLP layer step, forward and gradients, on the card
    against the plain versions on the CPU. With one hidden layer the
    type-major branch: K11a and one K12a launch over every streamed type's
    slice forward; K12b per streamed type, K11b and (in the gather's
    backward) K5a backward.
    Without, the FiLM kernels K1-K3 with gamma = 1."""
    streamed = sum(not s for s in ranked_graph.flat.tm_self)
    assert streamed == 4 and ranked_graph.flat.tm_self[0]
    own = (dict(expand_add_act=1, expand_add_act_bwd=1, segsum=1,
                act_agg=1, act_agg_bwd=streamed) if kind
           else dict(film_fwd=1, film_bwd_dgb=1, film_src_bwd=1))
    rng = np.random.default_rng(6)
    num_types, d = ranked_graph.num_edge_types, 64
    sizes = [2 * d] + [d] * (kind + 1)
    params = [(rng.standard_normal((num_types, a, b)) / np.sqrt(a)).astype(
        np.float32) for a, b in zip(sizes[:-1], sizes[1:])]
    h = rng.standard_normal((ranked_graph.n_pad, d)).astype(np.float32)
    w = rng.standard_normal((ranked_graph.n_pad, d)).astype(np.float32)
    results = []
    for device in (dev, torch.device("cpu")):
        g = graph_to_device(ranked_graph, device)
        p = {"edge_mlp": [torch.tensor(v, device=device, requires_grad=True)
                          for v in params],
             "ln": {"scale": torch.ones(d, device=device),
                    "bias": torch.zeros(d, device=device)}}
        hh = torch.tensor(h, device=device, requires_grad=True)
        launches = dict(rs.LAUNCHES)
        out = layers.gnn_edge_mlp_apply(
            p, g, hh, activation_function="gelu" if kind else "relu",
            num_edge_hidden_layers=kind)
        (out * torch.tensor(w, device=device)).sum().backward()
        if device.type == "cuda":
            assert {k: rs.LAUNCHES[k] - launches[k] for k in launches} == dict(
                {k: 0 for k in launches}, **own)
        results.append([x.detach().cpu().numpy() for x in
                        [out, hh.grad] + [v.grad for v in p["edge_mlp"]]])
    for card, cpu in zip(*results):
        # As for the other layers: a few streamed values round to the
        # neighbouring bf16 number on one device (2^-8 relative each); the
        # per-type bf16 products sum in another order on the card.
        rel = np.linalg.norm(card - cpu) / np.linalg.norm(cpu)
        assert rel < 2e-3, rel


# ---- K10, K14: the typed dense aggregate and the Edge-MLP1 source pass -------

# (D_h, D): the tuned width, two widths that are no multiple of 8 and D_h
# != D; K10b stages 128 x (D_h + D) bf16 values, above 48 KB from 96 on.
K10_CASES = [(128, 128), (44, 44), (64, 200)]


@pytest.mark.parametrize("dh,d", K10_CASES)
@pytest.mark.parametrize("act", sorted(rs.ACT_IDS))
def test_typed_dense_agg_matches_plain_on_card(dev, ranked_graph, act, dh, d):
    """K10a and K10b against their plain versions over the receiver-sorted
    stream and its edge types (a few set out of range: they add nothing).
    The kernels form each product in f32 in another order than the plain
    version's matmul: each output may differ from the plain version's by no
    more than the same math in the kernel's order does, plus the order
    bound of the sums (typed_dense_agg_bounds and typed_dense_agg_bwd_check
    state the bounds; dW is also held by norm)."""
    flat = ranked_graph.flat
    ranks, rows = flat.rcv_rank, rs.rank_table_rows(ranked_graph.n_pad, 256)
    e = ranks.shape[0]
    types = flat.edge_type.clone()
    types[::101] = ranked_graph.num_edge_types
    gen = torch.Generator(device=dev).manual_seed(dh + d)
    x = torch.randn((e, dh), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((ranked_graph.num_edge_types, dh, d), generator=gen,
                     device=dev) / np.sqrt(dh)).to(torch.bfloat16)
    g16 = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    before = dict(rs.LAUNCHES)
    got = rs._typed_dense_agg_impl(x, w, types, ranks, table_rows=rows,
                                   act=act)
    dx, dw = rs._typed_dense_agg_bwd_impl(x, w, g16, types, ranks, act=act)
    torch.cuda.synchronize()
    assert {k: rs.LAUNCHES[k] - before[k] for k in before} == dict(
        {k: 0 for k in before}, typed_dense_agg=1, typed_dense_agg_bwd=1)
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    assert dx.dtype == torch.bfloat16 and dx.shape == (e, dh)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    abs_sums, counts, slack = typed_dense_agg_bounds(torch, rs, x, w, types,
                                                     ranks, rows, act)
    check_kernel("typed_dense_agg", got,
                 rs._typed_dense_agg_plain(x, w, types, ranks, rows, act),
                 abs_sums, counts, torch, slack=slack)
    plain_bwd = rs._typed_dense_agg_bwd_plain(x, w, g16, types, ranks, act)
    typed_dense_agg_bwd_check(torch, rs, (dx, dw), plain_bwd, x, w, g16,
                              types, ranks, act)
    assert (dx[types >= ranked_graph.num_edge_types] == 0).all()
    # The same check fails a planted dW = 0 and a dx sum one column short.
    for fault in ("dw_zero", "dx_drops_last_term"):
        _, planted = k10_emulated(fault, x, w, g16, types, ranks, rows, act)
        with pytest.raises(AssertionError):
            typed_dense_agg_bwd_check(torch, rs, planted, plain_bwd, x, w,
                                      g16, types, ranks, act)


@pytest.mark.parametrize("d", [128, 44])
@pytest.mark.parametrize("stream", ["undiluted", "diluted"])
def test_emlp1_src_bwd_matches_plain_on_card(dev, ranked_graph, diluted_graph,
                                            stream, d):
    """K14 over the src-sorted stream of a graph with a self-loop type
    (its src ranks get no column) and over a diluted one (zero beta | g
    rows at the fill slots): within the order bound of the sums plus what
    the terms in the kernel's order differ by from the plain version's
    (emlp1_src_bwd_bounds); slots at or past e_real add nothing."""
    g = ranked_graph if stream == "undiluted" else diluted_graph
    flat = g.flat
    ranks = flat.src_sorted_rank if stream == "undiluted" else flat.sd_rank
    e, rows = ranks.shape[0], flat.src_from_rank.shape[0]
    nonself = [l for l, s in enumerate(flat.tm_self) if not s]
    cols = rs.src_rank_type_columns(flat.src_from_rank, g.n_pad, flat.tm_self)
    assert any(flat.tm_self) and (cols >= 0).any()
    gen = torch.Generator(device=dev).manual_seed(d)
    gcb = torch.randn((e, 2 * d), generator=gen, device=dev)
    if stream == "diluted":
        gcb[flat.sd_fine == int(SD_FILL)] = 0.0
    gcb = gcb.to(torch.bfloat16)
    t = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((len(nonself), d, d), generator=gen, device=dev)
         / np.sqrt(d)).to(torch.bfloat16)
    e_real = torch.tensor([e - 500], dtype=torch.int32, device=dev)
    before = rs.LAUNCHES["emlp1_src_bwd"]
    got = rs._emlp1_src_bwd_impl(gcb, t, cols, w, e_real, ranks,
                                 table_rows=rows, act="gelu")
    torch.cuda.synchronize()
    assert rs.LAUNCHES["emlp1_src_bwd"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    want = rs._emlp1_src_bwd_plain(gcb, t, cols, w, e_real, ranks, rows,
                                   "gelu")
    abs_sums, counts, slack = emlp1_src_bwd_bounds(
        torch, rs, gcb, t, cols, w, e_real, ranks, rows, "gelu")
    check_kernel("emlp1_src_bwd", got, want, abs_sums, counts, torch,
                 slack=slack)
    # The same check fails a planted dx sum one column short.
    planted = k14_emulated("dx_drops_last_term", gcb, t, cols, w, e_real,
                           ranks, rows, "gelu")
    with pytest.raises(AssertionError):
        check_kernel("emlp1_src_bwd", planted, want, abs_sums, counts, torch,
                     slack=slack)
    fed = torch.zeros(rows, dtype=torch.bool, device=dev)
    fed[ranks[:e - 500].long()] = True
    assert (got[~fed] == 0).all()


def test_k10_k14_wrappers_refuse_what_the_kernels_do_not_take(dev,
                                                             ranked_graph):
    flat = ranked_graph.flat
    ranks = flat.rcv_rank
    e, types = ranks.shape[0], flat.edge_type
    bf = dict(device=dev, dtype=torch.bfloat16)
    x, w = torch.zeros((e, 16), **bf), torch.zeros((5, 16, 16), **bf)
    g16 = torch.zeros((8, 16), **bf)
    before = dict(rs.LAUNCHES)
    with pytest.raises(TypeError):  # f32 weights
        rs._typed_dense_agg_impl(x, w.float(), types, ranks, table_rows=8,
                                 act="gelu")
    with pytest.raises(TypeError):  # int64 types
        rs._typed_dense_agg_impl(x, w, types.long(), ranks, table_rows=8,
                                 act="gelu")
    with pytest.raises(TypeError):  # an f32 cotangent table
        rs._typed_dense_agg_bwd_impl(x, w, g16.float(), types, ranks,
                                     act="gelu")
    with pytest.raises(ValueError):  # a stream that is a column slice
        rs._typed_dense_agg_impl(torch.zeros((e, 32), **bf)[:, :16], w, types,
                                 ranks, table_rows=8, act="gelu")
    src = flat.src_sorted_rank
    rows = flat.src_from_rank.shape[0]
    cols = torch.zeros(rows, device=dev, dtype=torch.int32)
    e_real = torch.tensor([e], device=dev, dtype=torch.int32)
    with pytest.raises(TypeError):  # an int64 e_real
        rs._emlp1_src_bwd_impl(torch.zeros((e, 32), **bf),
                               torch.zeros((rows, 16), **bf), cols,
                               torch.zeros((1, 16, 16), **bf), e_real.long(),
                               src, table_rows=rows, act="gelu")
    assert rs.LAUNCHES == before  # nothing refused was launched


def _layer_on_card_and_cpu(dev, graph, apply, params, d, seed, **kw):
    """One layer step, forward and gradients, on the card and on the CPU
    (plain versions): ([out, dh, dW...] per device, the card's launches)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((graph.n_pad, d)).astype(np.float32)
    w = rng.standard_normal((graph.n_pad, d)).astype(np.float32)
    results, launches = [], None
    for device in (dev, torch.device("cpu")):
        g = graph_to_device(graph, device)
        p = {"edge_mlp": [torch.tensor(v, device=device, requires_grad=True)
                          for v in params],
             "ln": {"scale": torch.ones(d, device=device),
                    "bias": torch.zeros(d, device=device)}}
        hh = torch.tensor(h, device=device, requires_grad=True)
        before = dict(rs.LAUNCHES)
        out = apply(p, g, hh, **kw)
        (out * torch.tensor(w, device=device)).sum().backward()
        if device.type == "cuda":
            launches = {k: rs.LAUNCHES[k] - before[k] for k in before
                        if rs.LAUNCHES[k] > before[k]}
        results.append([x.detach().cpu().numpy() for x in
                        [out, hh.grad] + [v.grad for v in p["edge_mlp"]]])
    return results, launches


@pytest.mark.parametrize("branch", ["fused1", "fused_src1", "ranked",
                                    "rgin"])
def test_new_branches_on_card_match_cpu(dev, ranked_graph, monkeypatch,
                                        branch):
    """GNN-Edge-MLP1's fused1 (the type-major view hidden from the gate:
    K5b and K10a forward; K10b and two K5a backward) and fused_src1
    (ENABLE_EMLP1_SRC_PASS set: K14 in place of the type-major gather's
    K5a), GNN-Edge-MLP's ranked branch and RGIN's (K5a both ways), one
    layer step on the card against the CPU."""
    streamed = sum(not s for s in ranked_graph.flat.tm_self)
    d, num_types = 64, ranked_graph.num_edge_types
    rng = np.random.default_rng(7)
    target = branch in ("fused1", "fused_src1")
    sizes = [2 * d if target else d, d, d]
    params = [(rng.standard_normal((num_types, a, b)) / np.sqrt(a)).astype(
        np.float32) for a, b in zip(sizes[:-1], sizes[1:])]
    apply, kw = layers.gnn_edge_mlp_apply, dict(
        activation_function="gelu", use_target_state_as_input=target)
    if branch == "fused1":
        monkeypatch.setattr(layers, "tm_available", lambda graph: False)
        own = dict(expand=1, typed_dense_agg=1, typed_dense_agg_bwd=1,
                   segsum=2)
    elif branch == "fused_src1":
        monkeypatch.setattr(rs, "ENABLE_EMLP1_SRC_PASS", True)
        own = dict(expand_add_act=1, act_agg=1, act_agg_bwd=streamed,
                   expand_add_act_bwd=1, emlp1_src_bwd=1)
    else:
        own = dict(segsum=2)
        if branch == "rgin":
            apply, kw = layers.rgin_apply, dict(activation_function="elu")
    results, launches = _layer_on_card_and_cpu(dev, ranked_graph, apply,
                                               params, d, 8, **kw)
    assert launches == own
    for card, cpu in zip(*results):
        # As for the other layers: a few streamed values round to the
        # neighbouring bf16 number on one device (2^-8 relative each); the
        # typed products sum in another order on the card.
        rel = np.linalg.norm(card - cpu) / np.linalg.norm(cpu)
        assert rel < 2e-3, rel


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("which", ["ranked", "diluted"])
def test_rgdcn_layer_on_card_matches_cpu(dev, ranked_graph, diluted_graph,
                                         which, normalize):
    """RGDCN's fine-form neighbour sums ("pallas": the fused gather + fine
    segment-sum, K5a forward over the fine ranks and K5a backward over the
    src-sorted stream, the diluted one where it engaged and normalisation
    is off), one layer step on the card against the CPU."""
    graph = ranked_graph if which == "ranked" else diluted_graph
    d, channels = 64, 4
    k = d // channels
    rng = np.random.default_rng(9)
    w_wc = (rng.standard_normal((graph.num_edge_types, channels, k, k * k))
            / k ** 2).astype(np.float32)
    h = rng.standard_normal((graph.n_pad, d)).astype(np.float32)
    w = rng.standard_normal((graph.n_pad, d)).astype(np.float32)
    assert layers.rgdcn_sums_form(graph, "pallas", "auto") == "fine"
    results, launches = [], None
    for device in (dev, torch.device("cpu")):
        g = graph_to_device(graph, device)
        p = {"W_wc": torch.tensor(w_wc, device=device, requires_grad=True)}
        hh = torch.tensor(h, device=device, requires_grad=True)
        before = dict(rs.LAUNCHES)
        out = layers.rgdcn_apply(p, g, hh, num_channels=channels,
                                 aggregation_strategy="pallas",
                                 normalize_by_num_incoming=normalize)
        (out * torch.tensor(w, device=device)).sum().backward()
        if device.type == "cuda":
            launches = {n: rs.LAUNCHES[n] - before[n] for n in before
                        if rs.LAUNCHES[n] > before[n]}
        results.append([x.detach().cpu().numpy()
                        for x in (out, hh.grad, p["W_wc"].grad)])
    assert launches == dict(segsum=2)
    for card, cpu in zip(*results):
        # The same bf16 terms; the f32 contractions sum in other orders on
        # the card, which can round a cotangent to the neighbouring bf16
        # number (2^-8 relative) before the backward K5a.
        rel = np.linalg.norm(card - cpu) / np.linalg.norm(cpu)
        assert rel < 2e-3, rel


# ---- K13, K15: row-major weighted segment-sum, sign-mask FiLM kernels ------

@pytest.mark.parametrize("k,d", [(k, d) for k, d, x in HEAD_CASES if not x])
def test_wseg_matches_plain_on_card(dev, graph, k, d):
    """K13a and its plain version sum the same bf16-rounded products in two
    orders, reading the [E, K] weights in place."""
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    e = ranks.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d + k)
    msgs = torch.randn((e, d), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.rand((e, k), generator=gen, device=dev)
    before = rs.LAUNCHES["wseg"]
    got = rs._wseg_impl(msgs, w, ranks, table_rows=rows, num_heads=k)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["wseg"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    want = rs._wseg_plain(msgs, w, ranks, rows)
    terms = rs._bf16_terms(msgs.float() * rs._head_replicate(w.t(), d))
    check_kernel("wseg", got, want, *_order_inputs(dev, ranks, rows, terms),
                 torch)


@pytest.mark.parametrize("k,d,offset", [(k, d, 0) for k, d, x in HEAD_CASES
                                        if not x] + [(8, 128, 1)])
def test_wseg_bwd_matches_plain_on_card(dev, graph, k, d, offset):
    """K13b: d_msgs equals the plain version's exactly; d_w, an f32 sum of
    D / K exact products in another order, within the order bound, and the
    same check rejects a d_w that is zero. A stream one bf16 past an
    aligned address takes the 2-byte path."""
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    e = ranks.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d * k + 1)
    base = torch.randn(e * d + offset, generator=gen, device=dev).to(
        torch.bfloat16)
    msgs = base[offset:].view(e, d)
    w = torch.rand((e, k), generator=gen, device=dev)
    g16 = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    before = rs.LAUNCHES["wseg_bwd"]
    dm, dw = rs._wseg_bwd_impl(msgs, w, g16, ranks, num_heads=k)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["wseg_bwd"] == before + 1
    assert dw.dtype == torch.float32 and dw.shape == (e, k)
    dm_want, dw_want = rs._wseg_bwd_plain(msgs, w, g16, ranks)
    check_exact("wseg_bwd d_msgs", dm, dm_want, torch)
    g_e = g16.index_select(0, ranks)
    head_dw_check("wseg_bwd d_w", dw, dw_want, msgs, g_e, torch)
    with pytest.raises(AssertionError):
        head_dw_check("wseg_bwd d_w (zero)", torch.zeros_like(dw), dw_want,
                      msgs, g_e, torch)


def test_ranked_weighted_segment_sum_grad_on_card(dev, graph):
    """The autograd Function launches K13a forward and K13b backward, and
    its gradients are the wrappers' outputs."""
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    e, k, d = ranks.shape[0], 8, 64
    gen = torch.Generator(device=dev).manual_seed(5)
    msgs = torch.randn((e, d), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    w = torch.rand((e, k), generator=gen, device=dev).requires_grad_(True)
    g = torch.randn((rows, d), generator=gen, device=dev)
    before = dict(rs.LAUNCHES)
    out = rs.ranked_weighted_segment_sum(msgs, w, ranks, rows, k)
    out.backward(g)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["wseg"] == before["wseg"] + 1
    assert rs.LAUNCHES["wseg_bwd"] == before["wseg_bwd"] + 1
    dm, dw = rs._wseg_bwd_impl(msgs.detach(), w.detach(), g.bfloat16(),
                               ranks, num_heads=k)
    assert torch.equal(msgs.grad, dm)
    head_dw_check("ranked_weighted_segment_sum d_w", w.grad, dw,
                  msgs.detach(), g.bfloat16().index_select(0, ranks), torch)


@pytest.mark.parametrize("d", [128, 200, 48, 40])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "elu"])
def test_film_fwd_mask_matches_plain_and_film_fwd_on_card(dev, graph, act, d):
    """K15a: the mask equals the plain version's bit for bit (D = 40 and
    200 leave a part-filled 16-column group, 48 and 40 a part-filled
    warp), and the same exact check rejects a mask one bit off; the table
    equals K1's on the same inputs on every row that K1 sums in a fixed
    order and lies within the order bound of the plain version's."""
    msgs, gb, ranks = _inputs("film_fwd", graph.flat, d, dev)
    rows = gb.shape[0]
    before = rs.LAUNCHES["film_fwd_mask"]
    table, mask = rs._film_fwd_mask_impl(msgs, gb, ranks, act=act)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["film_fwd_mask"] == before + 1
    assert mask.dtype == torch.float32
    assert mask.shape == (ranks.shape[0], rs._mask_lanes(d))
    t_want, m_want = rs._film_fwd_mask_plain(msgs, gb, ranks, act)
    check_exact("film_fwd_mask mask", mask, m_want, torch)
    off = mask.clone()
    off[7, 0] = float(int(off[7, 0]) ^ 1)
    with pytest.raises(AssertionError):
        check_exact("film_fwd_mask mask (one bit off)", off, m_want, torch)
    fixed = ~seam_rows(torch, ranks, rows)
    k1 = rs._film_fwd_impl(msgs, gb, ranks, act=act)
    check_exact("film_fwd_mask table", table[fixed], k1[fixed], torch)
    check_kernel("film_fwd_mask", table, t_want,
                 *_terms_and_counts("film_fwd", act, (msgs, gb, ranks),
                                    graph.flat, dev), torch)


@pytest.mark.parametrize("d", [128, 200, 40])
@pytest.mark.parametrize("leak", [0.0, 0.2])
@pytest.mark.parametrize("stream", ["undiluted", "diluted"])
def test_masked_segsum_matches_plain_on_card(dev, graph, diluted_graph,
                                             stream, leak, d):
    """K15b and its plain version sum the same bf16-rounded masked terms in
    two orders over the src-sorted stream (on the diluted one, fill slots
    carry zero C rows); the same check rejects the table of a mask one bit
    off."""
    g = graph if stream == "undiluted" else diluted_graph
    fine, ranks, _ = layers.src_stream(g.flat)
    rows = g.flat.src_from_rank.shape[0]
    e = ranks.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d)
    lanes = rs._mask_lanes(d)
    mask = torch.zeros((e, lanes), device=dev)
    mask[:, :-(-d // 16)] = torch.randint(0, 2 ** 16, (e, -(-d // 16)),
                                          generator=gen, device=dev).float()
    c = torch.randn((e, d), generator=gen, device=dev).to(torch.bfloat16)
    c[fine == int(SD_FILL)] = 0
    before = rs.LAUNCHES["masked_segsum"]
    got = rs._masked_segsum_impl(mask, c, ranks, table_rows=rows, leak=leak)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["masked_segsum"] == before + 1
    want = rs._masked_segsum_plain(mask, c, ranks, rows, leak)
    bounds = _order_inputs(dev, ranks, rows,
                           masked_terms(torch, rs, mask, c, leak))
    check_kernel("masked_segsum", got, want, *bounds, torch)
    off = mask.clone()
    off[0, 0] = float(int(off[0, 0]) ^ 1)
    with pytest.raises(AssertionError):
        check_kernel("masked_segsum (mask one bit off)", got,
                     rs._masked_segsum_plain(off, c, ranks, rows, leak),
                     *bounds, torch)


def test_k13_k15_wrappers_refuse_what_the_kernels_do_not_take(dev, graph):
    ranks = graph.flat.rcv_rank
    rows = rs.rank_table_rows(graph.n_pad, 256)
    e = ranks.shape[0]
    bf = dict(device=dev, dtype=torch.bfloat16)
    msgs, w = torch.zeros((e, 16), **bf), torch.zeros((e, 4), device=dev)
    g16 = torch.zeros((rows, 16), **bf)
    before = dict(rs.LAUNCHES)
    with pytest.raises(TypeError):  # an f32 stream
        rs._wseg_impl(msgs.float(), w, ranks, table_rows=rows, num_heads=4)
    with pytest.raises(ValueError):  # head-major weights
        rs._wseg_impl(msgs, w.t().contiguous(), ranks, table_rows=rows,
                      num_heads=4)
    with pytest.raises(TypeError):  # an f32 cotangent table
        rs._wseg_bwd_impl(msgs, w, g16.float(), ranks, num_heads=4)
    with pytest.raises(ValueError):  # a transposed weight view
        rs._wseg_bwd_impl(msgs, w.t().contiguous().t(), g16, ranks,
                          num_heads=4)
    gb = torch.zeros((rows, 32), **bf)
    with pytest.raises(TypeError):  # an f32 gamma | beta table
        rs._film_fwd_mask_impl(msgs, gb.float(), ranks, act="relu")
    mask = torch.zeros((e, 32), device=dev)
    with pytest.raises(TypeError):  # an int32 mask
        rs._masked_segsum_impl(mask.int(), msgs, ranks, table_rows=rows,
                               leak=0.0)
    with pytest.raises(ValueError):  # two lanes hold 32 of 48 columns
        rs._masked_segsum_impl(mask[:, :2], torch.zeros((e, 48), **bf), ranks,
                               table_rows=rows, leak=0.0)
    assert rs.LAUNCHES == before  # nothing refused was launched
