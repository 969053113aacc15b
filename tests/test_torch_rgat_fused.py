"""RGAT's fused branch (rgat_fused_pass: K6b, K6a, K7a forward; K8, K6a,
K6b, K9 backward), the port against the JAX package on the CPU.

Inputs come from numpy with a fixed seed and go to both packages; the JAX
side runs its Pallas kernels in interpret mode, the port the kernels'
plain versions. Batches: the first 600-node QM9 pack (n_pad 640, E 10,240;
undiluted src stream) and a numpy-made graph of PPI-like degree, where the
diluted src stream engages. Logits stay below 44 wherever gradients are
compared with the JAX package's streamed softmax; the fused pass itself
has no such limit and is also compared beyond the clamp at 50.

tests/test_torch_rgat.py holds the STREAMED branch against JAX with both
packages' fused gates forced off; here both gates are left as they are."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import graph as j_graph
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import edge_ops as t_edge
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

from test_torch_graph import ppi_like_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
D = 64


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


def load_task(mod, path, count):
    task = mod.QM9_Task(mod.QM9_Task.default_params())
    return task, task._QM9_Task__load_data(path)[:count]


@pytest.fixture(scope="module")
def qm9():
    """(JAX task, port task, JAX batch, port batch): first 600-node pack."""
    jt, jd = load_task(j_qm9, "data/qm9/valid.jsonl.gz", 200)
    tt, td = load_task(t_qm9, "data/qm9/valid.jsonl.gz", 200)
    jb = next(jt.make_minibatch_iterator(jd, j_base.DataFold.VALIDATION, 600))
    tb = next(tt.make_minibatch_iterator(td, t_base.DataFold.VALIDATION, 600))
    assert jb.graph.n_pad == 640 and tb.graph.flat.rcv_rank.shape[0] == 10240
    return jt, tt, jb, tb


@pytest.fixture(scope="module")
def ppi():
    """(JAX GraphBatch, port GraphBatch) of a PPI-like graph whose diluted
    src stream engaged, edge blocks padded to whole 2048-edge rows."""
    feats, adj, gids = ppi_like_graph(4, num_nodes=500, degree=12)
    e_pads = [-(-a.shape[0] // 2048) * 2048 for a in adj]
    jg = j_graph.pad_graph_batch(feats, adj, gids, 2, e_pads=e_pads)
    tg = t_graph.pad_graph_batch(feats, adj, gids, 2, e_pads=e_pads)
    assert tg.flat.win_sd and (tg.flat.sd_fine == int(t_graph.SD_FILL)).any()
    return jg, tg


def graphs(qm9, ppi, name):
    return (qm9[2].graph, qm9[3].graph) if name == "qm9" else ppi


def bf16_pair(x):
    """The same bf16 values for both packages (both round to nearest)."""
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def i32(t):
    return jnp.asarray(t.numpy())


def bf16_round(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ---- K8 -----------------------------------------------------------------

@pytest.mark.parametrize("k,dim,extra", [(4, 32, 0), (8, 64, 0), (8, 128, 0),
                                         (4, 64, 4), (8, 128, 8)])
@pytest.mark.parametrize("graph_name", ["qm9", "ppi"])
def test_wseg_t_dw_plain_matches_pallas(qm9, ppi, graph_name, k, dim, extra):
    """K8 against _wseg_t_dw_impl in interpret mode: d_w_t[k, e] is an f32
    sum of D / K exact products (bf16 x bf16) in two orders, within 1e-5 of
    the array's scale (as K7b's d_w_t). The `extra` cases feed the fused
    branch's [E, D + K] stream with d_used = D: the extra columns, here
    large, must not be read."""
    jg, tg = graphs(qm9, ppi, graph_name)
    ranks = tg.flat.rcv_rank
    rows = t_rs.rank_table_rows(tg.n_pad, 256)
    rng = np.random.RandomState(dim + k)
    e = ranks.shape[0]
    m = rng.randn(e, dim + extra).astype(np.float32)
    m[:, dim:] = 1e4
    g = rng.randn(rows, dim).astype(np.float32)
    (jm, tm), (jg16, tg16) = bf16_pair(m), bf16_pair(g)
    kw = dict(num_heads=k, block_edges=256, d_used=dim if extra else None)
    want = np.asarray(j_rs._wseg_t_dw_impl(
        jm, jg16, i32(ranks), win=token_window(jg.flat.win_fine), **kw))
    got = t_rs._wseg_t_dw_impl(tm, tg16, ranks, **kw)
    assert got.dtype == torch.float32 and got.shape == (k, e)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # It is the d_w_t half of K7b.
    _, dw = t_rs._wseg_t_bwd_impl(tm[:, :dim].contiguous(),
                                  torch.ones(k, e), tg16, ranks, num_heads=k)
    assert torch.equal(got, dw)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


# ---- K9 -----------------------------------------------------------------

def src_bwd_inputs(tg, k, dim, seed, diluted):
    """K9's inputs as the fused backward builds them: a random bf16 side
    table [RPAD, D + 3K] (cotangent | target logits | positive denominator
    | correction) whose slack rows are zero, gathered per edge of the src
    stream with fill keys clamped onto an appended zero row, and a random
    bf16 t | lsrc table in src-rank order. A few logits lie beyond the
    clamp at 50 on both sides."""
    flat = tg.flat
    rng = np.random.RandomState(seed)
    rpad, rsrc = flat.fine_to_flat.shape[0], flat.src_from_rank.shape[0]
    fine, ranks = ((flat.sd_fine, flat.sd_rank) if diluted
                   else (flat.fine_rank_by_src, flat.src_sorted_rank))
    side = rng.randn(rpad, dim + 3 * k).astype(np.float32)
    side[:, dim:dim + k] *= 2.0
    side[:, dim + k:dim + 2 * k] = 0.5 + 4 * rng.rand(rpad, k)
    side[::37, dim:dim + k] = 80.0      # leaky(pre) clamps high
    side[5::41, dim:dim + k] = -400.0   # 0.2 * pre clamps low
    side[int(flat.tgt_rank.max()):] = 0.0  # the dump rank and the slack rows
    side_ext = np.concatenate([bf16_round(side),
                               np.zeros((8, dim + 3 * k), np.float32)])
    gcb = side_ext[np.minimum(fine.numpy(), rpad)]
    t_ext = rng.randn(rsrc, dim + k).astype(np.float32)
    return gcb, t_ext, ranks, rsrc


@pytest.mark.parametrize("k,dim", [(8, 64), (4, 32), (8, 128)])
@pytest.mark.parametrize("graph_name,diluted", [("qm9", False),
                                                ("ppi", False),
                                                ("ppi", True)])
def test_rgat_src_bwd_plain_matches_pallas(qm9, ppi, graph_name, diluted, k,
                                           dim):
    """K9 against _rgat_src_bwd_impl in interpret mode on the undiluted src
    stream (QM9 and the PPI-like graph) and on the diluted one. Each row
    sums bf16-rounded terms in f32. The terms go through exp and a
    division in two libraries, which differ by an ulp, so a term may round
    to the neighbouring bf16 number (one ulp, at most 2^-7 of the term):
    per row the difference is held to 2^-7 * sum|term| on top of 1e-5 *
    sum|term| for the f32 sum order.
    Fill slots and padded edges add exact zeros: rows no real edge feeds
    are zero on both sides. Logits beyond the clamp give no logit
    cotangent (columns D...D+K), on both sides."""
    jg, tg = graphs(qm9, ppi, graph_name)
    gcb, t_ext, ranks, rsrc = src_bwd_inputs(tg, k, dim, seed=dim + k,
                                             diluted=diluted)
    (jgcb, tgcb), (jt, tt) = bf16_pair(gcb), bf16_pair(t_ext)
    win = token_window(jg.flat.win_sd if diluted else jg.flat.win_src)
    want = np.asarray(j_rs._rgat_src_bwd_impl(
        jgcb, jt, i32(ranks), table_rows=rsrc, num_heads=k, block_edges=256,
        clamp=50.0, win=win))
    got = t_rs._rgat_src_bwd_impl(tgcb, tt, ranks, table_rows=rsrc,
                                  num_heads=k, clamp=50.0)
    assert got.dtype == torch.float32 and got.shape == (rsrc, dim + k)
    got = got.numpy()
    assert np.isfinite(got).all()
    # Per-row sum of |term|: the plain version with every edge a rank of
    # its own gives the bf16-rounded terms edge by edge.
    e = ranks.shape[0]
    t_edge_rows = tt.index_select(0, ranks.long())
    per_edge = t_rs._rgat_src_bwd_plain(
        tgcb, t_edge_rows, torch.arange(e, dtype=torch.int32), e, k,
        50.0).numpy()
    terms_abs = np.zeros((rsrc, dim + k))
    np.add.at(terms_abs, ranks.numpy(), np.abs(per_edge))
    pre = t_edge_rows.float()[:, dim:] + tgcb.float()[:, dim:dim + k]
    logit = torch.where(pre > 0, pre, 0.2 * pre)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bound = (2.0 ** -7 + 1e-5) * terms_abs + 1e-30
    assert (err <= bound).all(), float((err / bound).max())
    assert (got != want).mean() < 0.3
    real_rows = np.zeros(rsrc, bool)
    real = (tgcb.float().abs().sum(1) > 0).numpy()
    real_rows[ranks.numpy()[real]] = True
    assert (got[~real_rows] == 0).all() and (want[~real_rows] == 0).all()
    clamped = (logit.abs() >= 50.0).numpy() & real[:, None]
    assert clamped.any() and (per_edge[:, dim:][clamped] == 0).all()
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


def test_new_wrappers_check_shapes():
    ranks = torch.zeros(8, dtype=torch.int32)
    bf = dict(dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # g table of another width
        t_rs._wseg_t_dw_impl(torch.zeros(8, 16, **bf), torch.zeros(4, 8, **bf),
                             ranks, num_heads=4)
    with pytest.raises(ValueError):  # d_used wider than the stream
        t_rs._wseg_t_dw_impl(torch.zeros(8, 16, **bf),
                             torch.zeros(4, 32, **bf), ranks, num_heads=4,
                             d_used=32)
    with pytest.raises(ValueError):  # 16 columns do not split into 3 heads
        t_rs._wseg_t_dw_impl(torch.zeros(8, 16, **bf),
                             torch.zeros(4, 16, **bf), ranks, num_heads=3)
    with pytest.raises(ValueError):  # the stream is not D + 3K wide
        t_rs._rgat_src_bwd_impl(torch.zeros(8, 24, **bf),
                                torch.zeros(6, 20, **bf), ranks,
                                table_rows=6, num_heads=4, clamp=50.0)
    with pytest.raises(ValueError):  # the t table is not table_rows high
        t_rs._rgat_src_bwd_impl(torch.zeros(8, 28, **bf),
                                torch.zeros(5, 20, **bf), ranks,
                                table_rows=6, num_heads=4, clamp=50.0)
    assert set(t_rs.LAUNCHES) >= {"film_bwd", "wseg_t_dw", "rgat_src_bwd"}
    # the package's 23 kernels, the nine K16 kernel bodies of the
    # harnesses in tf_gnn_samples_torch/tools/ and the earlier designs of
    # K3, K4, K12a, K9, K7a, K6a, K10a, K10b, K14, K15a and K15b
    # (tools/earlier_designs.py)
    assert len(t_rs.LAUNCHES) == 23 + 9 + 11


def test_fused_gate_keeps_the_semantic_terms(qm9, ppi, monkeypatch):
    """rgat_fused_supported: the JAX gate's semantic terms, and the fused
    pass only where the type-stacked node table is shorter than the edge
    stream (the docstring has the measurement). The tuned QM9 batch
    (256,000 table rows, 161,792 edges) takes the streamed branch, as it
    does in the JAX package, whose gate says no there on memory; the small
    batches of these tests take the fused one in both packages."""
    rows = t_rs.rank_table_rows(51200, 256)
    tuned = (161792, 128, 8, rows, t_rs.src_rank_table_rows(5 * 51200, 161792))
    assert tuned[4] == 162056
    assert not t_rs.rgat_fused_supported(*tuned)
    assert not j_rs.rgat_fused_supported(*tuned)
    dense = (161792, 128, 8, rows, t_rs.src_rank_table_rows(3 * 8192, 161792))
    assert t_rs.rgat_fused_supported(*dense)
    assert not t_rs.rgat_fused_supported(161792, 128, 7, *dense[3:])
    for tg in (qm9[3].graph, ppi[1]):
        e, src_rows = tg.flat.src_flat.shape[0], tg.flat.src_from_rank.shape[0]
        assert tg.num_edge_types * tg.n_pad < e
        args = (e, D, 8, t_rs.rank_table_rows(tg.n_pad, 256), src_rows)
        assert t_rs.rgat_fused_supported(*args)
        assert j_rs.rgat_fused_supported(*args)
    monkeypatch.setattr(t_rs, "ENABLE_FUSED_SRC_PASS", False)
    assert not t_rs.rgat_fused_supported(*dense)
    assert not t_rs.film_fused_src_supported("elu")


# ---- rgat_fused_pass ------------------------------------------------------

def pass_inputs(tg, k, seed, lt_scale=1.0):
    rng = np.random.RandomState(seed)
    L, n_pad = tg.num_edge_types, tg.n_pad
    rpad = tg.flat.fine_to_flat.shape[0]
    rows = t_rs.rank_table_rows(n_pad, 256)
    t_flat = rng.randn(L * n_pad, D).astype(np.float32)
    lt = (lt_scale * rng.randn(rpad, k)).astype(np.float32)
    att = (0.2 * rng.randn(L, k, D // k)).astype(np.float32)
    g = rng.randn(rows, D).astype(np.float32)
    return t_flat, lt, att, g


def run_pass(pkg, graph, t_flat, lt, att, g, k):
    """(table, d_t, d_lt, d_att_src) of rgat_fused_pass under the cotangent
    g, each package fed its own src_stream."""
    flat = graph.flat
    if pkg == "jax":
        sd_fine, sd_rank, win_src = j_layers.src_stream(flat)

        def fn(a, b, c):
            return j_rs.rgat_fused_pass(
                a, b, c, flat.src_flat, sd_fine, sd_rank, flat.src_to_rank,
                flat.src_from_rank, flat.rcv_rank, flat.tgt_rank, flat.mask,
                flat.fine_to_rcv, graph.node_to_rank, k, graph.n_pad, 256,
                token_window(flat.win_fine), win_src)

        out, vjp = jax.vjp(fn, jnp.asarray(t_flat), jnp.asarray(lt),
                           jnp.asarray(att))
        return [np.asarray(a) for a in (out,) + vjp(jnp.asarray(g))]
    sd_fine, sd_rank, _ = t_layers.src_stream(flat)
    ins = [torch.from_numpy(a.copy()).requires_grad_(True)
           for a in (t_flat, lt, att)]
    out = t_rs.rgat_fused_pass(
        *ins, flat.src_flat, sd_fine, sd_rank, flat.src_to_rank,
        flat.src_from_rank, flat.rcv_rank, flat.tgt_rank, flat.mask,
        flat.fine_to_rcv, graph.node_to_rank, k, graph.n_pad)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g))
    return [a.detach().numpy() for a in (out,) + grads]


PASS_NAMES = ("table", "d_t", "d_lt", "d_att_src")


@pytest.mark.parametrize("k", [8, 4])
@pytest.mark.parametrize("graph_name", ["qm9", "ppi"])
def test_rgat_fused_pass_matches_jax(qm9, ppi, graph_name, k):
    """Forward and all three gradients of rgat_fused_pass, on the undiluted
    stream (QM9) and the diluted one (PPI-like graph). Both sides round at
    the same places (the source logits and every receiver-keyed value of
    the side table to bf16, every summed term to bf16), so they differ
    where f32 bits that differ (the node-side logit einsum, exp, sum
    orders) land on the other side of a bf16 rounding, 2^-8 of a value:
    held to 5e-4 relative norm and 2^-8 of the array's largest value per
    entry (measured <= 5.3e-6 and <= 1.3e-4; JAX's own test of this pass
    against its streamed branch allows 2e-2)."""
    jg, tg = graphs(qm9, ppi, graph_name)
    t_flat, lt, att, g = pass_inputs(tg, k, seed=10 + k)
    got = run_pass("torch", tg, t_flat, lt, att, g, k)
    want = run_pass("jax", jg, t_flat, lt, att, g, k)
    assert got[1].dtype == np.float32 and got[1].shape == t_flat.shape
    for name, a, b in zip(PASS_NAMES, got, want):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 5e-4, (name, rel)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2 ** -8 * float(np.abs(b).max()),
                                   err_msg=name)
    # Rows of t no real edge reads get no gradient.
    unread = tg.flat.src_to_rank.numpy() < 0
    assert unread.any() and (got[1][unread] == 0).all()
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


def test_rgat_fused_pass_clamp_indicator_matches_jax(qm9):
    """Logits beyond the clamp at 50: target logit halves of +80 (clamped
    high) and -400 (0.2 * pre clamped low) on some fine ranks. The
    backward hand-applies the clip's indicator in BOTH halves (the
    receiver-order d_lt and K9's source-order dpre), so those ranks get
    d_lt == 0 exactly in both packages, and the pass still agrees with
    JAX (same tolerances as above; this pass does not divide through
    autodiff, so the JAX side has no overflow above 44)."""
    jg, tg = graphs(qm9, None, "qm9")
    k = 8
    t_flat, lt, att, g = pass_inputs(tg, k, seed=3)
    n_fine = int(tg.flat.tgt_rank.max())  # real fine ranks: below the dump
    high, low = np.arange(3, n_fine, 29), np.arange(7, n_fine, 31)
    lt[high], lt[low] = 80.0, -400.0
    got = run_pass("torch", tg, t_flat, lt, att, g, k)
    want = run_pass("jax", jg, t_flat, lt, att, g, k)
    for idx in (high, low):
        assert (got[2][idx] == 0).all() and (want[2][idx] == 0).all()
    others = np.setdiff1d(np.arange(n_fine), np.concatenate([high, low]))
    assert (np.abs(got[2][others]).sum(1) > 0).mean() > 0.9
    for name, a, b in zip(PASS_NAMES, got, want):
        assert np.isfinite(a).all(), name
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 5e-4, (name, rel)


# ---- the layer and the model ----------------------------------------------

def _layer_inputs(tg, dim, seed):
    rng = np.random.RandomState(seed)
    L = tg.num_edge_types
    # Scaled so that the logits stay far below 44.
    params = {"W": (0.1 * rng.randn(L, dim, dim)).astype(np.float32),
              "att": (0.3 * rng.randn(L, 2 * dim)).astype(np.float32)}
    h = rng.randn(tg.n_pad, dim).astype(np.float32)
    w = rng.randn(tg.n_pad, dim).astype(np.float32)
    return params, h, w


def _run_rgat(pkg, graph, params, h, w, **kw):
    if pkg == "jax":
        def loss(p, hh):
            out = j_layers.rgat_apply(p, graph, hh, **kw)
            return jnp.sum(out * w), out

        (_, out), (gp, gh) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, h)
        return [np.asarray(a) for a in (out, gp["W"], gp["att"], gh)]
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = t_layers.rgat_apply(tp, graph, th, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return [a.detach().numpy() for a in (out, tp["W"].grad, tp["att"].grad,
                                         th.grad)]


@pytest.mark.parametrize("dim,heads", [(64, 8), (128, 8), (64, 4)])
@pytest.mark.parametrize("graph_name", ["qm9", "ppi"])
def test_rgat_fused_layer_matches_jax(qm9, ppi, monkeypatch, graph_name, dim,
                                      heads):
    """Output and the gradients with respect to W, att and h of a
    2-timestep RGAT layer whose both timesteps take the fused pass in both
    packages (the port's is counted; the JAX gate holds at these sizes).
    Same rounding points on both sides; a value whose f32 bits differ may
    round to the neighbouring bf16 number and the softmax denominator
    carries such a flip to a whole receiver: held to 2e-3 relative norm and
    2^-7 of the tensor's largest value per entry (measured <= 6.3e-4 and
    <= 2.3e-3). The port's streamed branch, another function (f32 source
    logits), stays within the 2e-2 JAX's own test allows between the two."""
    jg, tg = graphs(qm9, ppi, graph_name)
    assert j_rs.rgat_fused_supported(
        tg.flat.src_flat.shape[0], dim, heads,
        t_rs.rank_table_rows(tg.n_pad, 256), tg.flat.src_from_rank.shape[0])
    params, h, w = _layer_inputs(tg, dim, seed=dim + heads)
    kw = dict(num_heads=heads, activation_function="elu", num_timesteps=2,
              aggregation_strategy="pallas")
    calls = []
    orig = t_rs.rgat_fused_pass
    monkeypatch.setattr(t_rs, "rgat_fused_pass",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = _run_rgat("torch", tg, params, h, w, **kw)
    want = _run_rgat("jax", jg, params, h, w, **kw)
    assert len(calls) == 2
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions
    for name, a, b in zip(("out", "dW", "datt", "dh"), got, want):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 2e-3, (name, rel)
        np.testing.assert_allclose(
            a, b, rtol=0, atol=2 ** -7 * float(np.abs(b).max()),
            err_msg=name)
    # Forcing the gate off, as a test or a measurement does, takes the
    # streamed branch; "segment" the plain one.
    monkeypatch.setattr(t_rs, "rgat_fused_supported", lambda *a, **k: False)
    streamed = _run_rgat("torch", tg, params, h, w, **kw)
    assert len(calls) == 2
    np.testing.assert_allclose(streamed[0], got[0], rtol=2e-2, atol=2e-2)


def small_params(**extra):
    """The tuned QM9 RGAT hypers cut to hidden 64 and 2 layers, with
    dropout off (the two packages' random streams cannot match)."""
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "QM9_RGAT.json")) as f:
        hypers = json.load(f)["model_params"]
    params = j_model.RGAT_Model.default_params()
    params.update(hypers)
    params.update({"hidden_size": D, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 600})
    params.update(extra)
    return params


def test_fused_model_loss_grads_and_rmsprop_steps_match_jax(qm9, tmp_path):
    """Loss, every parameter gradient and two clipped RMSProp steps of the
    2-layer, 8-head model on the fused branch ("auto" in both packages),
    weights carried by params_from_jax (load_weights). Compared by norms:
    loss 1e-4, gradients 1e-3 relative (measured 1.3e-6 and <= 3.6e-5)."""
    jt, tt, jb, tb = qm9
    params = small_params()
    jm = j_model.RGAT_Model(dict(params), jt, "j", str(tmp_path))
    tm = t_model.RGAT_Model(dict(params), tt, "t", str(tmp_path),
                            device="cpu")
    tm.load_weights(j_model.flatten_params(jm.model_params_tree))
    jdev = jm._device_batch(jb)
    tdev = t_model.batch_to_device(tb, CPU)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True)(
            jm.model_params_tree)
    tloss, _ = tm._forward(tm.model_params_tree, tdev, None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4)
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, tgrads):
        rel = np.linalg.norm(g.numpy() - jflat[name]) / max(
            np.linalg.norm(jflat[name]), 1e-30)
        assert rel < 1e-3, (name, rel)
    step = jm._make_train_step()
    jp, jo = jm.model_params_tree, jm.opt_state
    for i in range(2):
        jp, jo, _ = step(jp, jo, jax.random.PRNGKey(i), jdev)
        tm._train_step(tdev)
    assert tm.opt_state.step == int(jo.step) == 2
    jflat = j_model.flatten_params(jp)
    tflat = t_model.params_to_jax(tm.model_params_tree)
    for name in jflat:
        # One RMSProp step moves a weight by ~lr / sqrt(0.02) = 4e-3; an
        # entry whose gradient is near zero takes a step set by the
        # gradient's last digits.
        np.testing.assert_allclose(tflat[name], jflat[name], rtol=1e-5,
                                   atol=1e-3, err_msg=name)
    assert t_edge.ranked_aggregation_ok(tb.graph, "sum")
