"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version (the FiLM kernels for every activation, the ranked
segment-sum for an f32 and a bf16 stream, the ranked expand exactly, the
head-major attention kernels K6 and K7), the wrappers' checks and launch
counts, and the fused GNN-FiLM, RGCN, GGNN and RGAT layers on the card
against the CPU.

Marked `cuda`; every test skips without a GPU. This file imports no JAX,
so it runs where JAX is absent (the repository's conftest imports it):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import check_kernel
from tf_gnn_samples_torch.nn import layers
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.ops.graph import graph_to_device, pad_graph_batch

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
    if kernel == "film_bwd_dgb":
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
    gcb, t, ranks, rows = args
    return (rs._film_src_bwd_plain(gcb, t, ranks, rows, act) if plain
            else rs._film_src_bwd_impl(gcb, t, ranks, table_rows=rows, act=act))


@pytest.mark.parametrize("d", [200, 48])
@pytest.mark.parametrize("act", sorted(rs.ACT_IDS))
@pytest.mark.parametrize("kernel", ["film_fwd", "film_bwd_dgb",
                                    "film_src_bwd"])
def test_kernel_matches_plain_on_card(dev, graph, kernel, act, d):
    """Kernel and plain version sum the same bf16 terms in two orders; each
    row must agree within the f32 summation-order bound (exactly for a
    single normal term; see chip_smoke.check_kernel). D = 200 spans two column passes of a 128-thread block;
    D = 48 a partly filled warp."""
    args = _inputs(kernel, graph.flat, d, dev)
    before = rs.LAUNCHES[kernel]
    got = _run(kernel, args, act, plain=False)
    torch.cuda.synchronize()
    assert rs.LAUNCHES[kernel] == before + 1
    want = _run(kernel, args, act, plain=True)
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
            assert all(rs.LAUNCHES[k] == launches[k] + (k.startswith("film"))
                       for k in launches)
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
    assert rs.LAUNCHES == before  # nothing refused was launched


@pytest.mark.parametrize("d,heads", [(128, 8), (64, 4)])
def test_rgat_layer_on_card_matches_cpu(dev, ranked_graph, d, heads):
    """One RGAT layer on its streamed branch, forward and gradients: K6a,
    K6b, K7a, K7b and (in the message gather's backward) K5a on the card,
    their plain versions on the CPU."""
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
                wseg_t_bwd=1, segsum=1)
        results.append([x.detach().cpu().numpy()
                        for x in (out, hh.grad, p["W"].grad, p["att"].grad)])
    for card, cpu in zip(*results):
        # As for the other layers: a few streamed values round to the
        # neighbouring bf16 number on one device (2^-8 relative each), and
        # the softmax denominator carries such a flip to a whole receiver.
        rel = np.linalg.norm(card - cpu) / np.linalg.norm(cpu)
        assert rel < 2e-3, rel
