"""The port's GNN-Edge-MLP slice against the JAX package's, on the CPU:
the plain versions of the four kernels (K11a expand_add_act, K11b its
backward, K12a act_agg, K12b its backward) against the Pallas kernels in
interpret mode, the two public functions' VJPs, the layer's three branches
(plain f32, type-major `tmajor1`, FiLM-kernel `fused0`) against JAX's
unrolled and "auto" branches, and 2-layer GNN-Edge-MLP0 / -MLP1 models with
weights, checkpoints and the CLIs carried across.

Graphs: the dense two-type graph with a pure self-loop type and one
doubled self edge (JAX's own fixture for its type-major test; its
type-major window is within the JAX gate's (0, 64]) and a graph of
PPI-like degree (its fine window is within compressive_window's (0, 64],
which JAX's fused0 gate needs); QM9 packs for the models."""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import graph as j_graph
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_tpu.utils import registry as j_registry
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import edge_ops as t_edge_ops
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9
from tf_gnn_samples_torch.utils import registry as t_registry

from test_torch_graph import ppi_like_graph, self_loop_graph
from test_torch_model import write_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64  # at 64 columns JAX's gather VJP is the ranked kernel in interpret mode
CPU = torch.device("cpu")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


def both_batches(feats, adj, gids, num_graphs, **kwargs):
    return (j_graph.pad_graph_batch(feats, adj, gids, num_graphs, **kwargs),
            t_graph.pad_graph_batch(feats, adj, gids, num_graphs, **kwargs))


@pytest.fixture(scope="module")
def loop_graphs():
    """(JAX batch, port batch) of the self-loop fixture: E = 4096."""
    feats, adj, gids = self_loop_graph()
    jg, tg = both_batches(feats, adj, gids, 1, n_pad=512,
                          e_pads=[2048, 2048], g_pad=16)
    assert 0 < tg.flat.win_tm <= 64 and tg.flat.tm_self == (False, True)
    return jg, tg


@pytest.fixture(scope="module")
def ppi_graphs():
    """(JAX batch, port batch) of a PPI-like graph: 600 nodes, two dense
    types and a self-loop type, E = 20,480."""
    feats, adj, gids = ppi_like_graph(0)
    e_pads = [-(-a.shape[0] // 2048) * 2048 for a in adj]
    jg, tg = both_batches(feats, adj, gids, 2, e_pads=e_pads)
    assert 0 < tg.flat.win_fine <= 64 and 0 < tg.flat.win_tm <= 64
    return jg, tg


def bf16_pair(x):
    """The same bf16 values for both packages (both round to nearest)."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    t = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                          t.to(torch.float32).numpy())
    return j, t


def f32(x):
    """A bf16 or f32 array of either package as float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


# Both sides sum the same bf16-rounded terms in f32, in two orders (MXU
# dots over one-hot windows against index_add_): a few f32 ulps of a row's
# sum.
SUMS = dict(rtol=1e-5, atol=1e-5)
# A value that both sides round to bf16 ONCE from f32 values that may
# differ in their last bit (two libraries' exp, tanh or erf polynomial):
# equal, or neighbouring bf16 numbers, 2^-7 of the value apart at most. A
# derivative that cancels (1 - tanh^2 in the tails) moves by a few f32 ulps
# of 1 whatever its own size: 1e-6 covers that times a cotangent below 4.
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)


def assert_bf16_equal_or_neighbours(got, want, exact):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    if exact:
        assert np.array_equal(f32(got), f32(want))
    else:
        np.testing.assert_allclose(f32(got), f32(want), **BF16_ULP)


# Activations made of comparisons and exact products only: both packages
# give the same bits.
EXACT_ACTS = ("relu", "leaky_relu", "linear")


# The JAX kernels run with win = 0 here, their data-independent window of
# block_edges + 8 rows: the batch's win_tm is measured over the blocks that
# hold an edge of a streamed type and is too narrow for the self-loop
# type's blocks (one rank per edge), whose rows the JAX kernels then drop.
WIN = 0


def tm_stream(tg, rng, scale=1.0):
    e = tg.flat.tm_rank.shape[0]
    rows = tg.flat.tm_to_flat.shape[0]
    m = bf16_pair((scale * rng.randn(e, D)).astype(np.float32))
    return e, rows, m, jnp.asarray(tg.flat.tm_rank.numpy())


@pytest.mark.parametrize("act", ["elu", "relu", "leaky_relu", "linear"])
def test_expand_add_act_plain_versions_match_pallas(loop_graphs, interpret,
                                                    act):
    """K11a and K11b. The forward rounds beta to bf16 before the add and x
    once; the backward takes act' from the output x, rounds dz once, and
    the ROUNDED dz is what d_m and the d_beta sums see."""
    jg, tg = loop_graphs
    rng = np.random.RandomState(0)
    e, rows, (jm, tm), jranks = tm_stream(tg, rng)
    win = WIN
    beta = rng.randn(rows, D).astype(np.float32)
    want = j_rs._expand_add_act_impl(jm, jnp.asarray(beta), jranks,
                                     block_edges=256, act=act, win=win)
    got = t_rs._expand_add_act_impl(tm, torch.from_numpy(beta),
                                    tg.flat.tm_rank, act=act)
    assert got.shape == want.shape
    assert_bf16_equal_or_neighbours(got, want, exact=act in EXACT_ACTS)

    # The backward on the SAME x (JAX's), so both read the same bits.
    x = np.array(f32(want))  # a writable copy
    (jx, tx), (jdx, tdx) = bf16_pair(x), bf16_pair(
        rng.randn(e, D).astype(np.float32))
    jdm, jdbeta = j_rs._expand_add_act_bwd_impl(
        jx, jdx, jranks, table_rows=rows, block_edges=256, act=act, win=win)
    tdm, tdbeta = t_rs._expand_add_act_bwd_impl(
        tx, tdx, tg.flat.tm_rank, table_rows=rows, act=act)
    # act' from the output is 1, 0, 0.2 or x + 1: one exact f32 product
    # (0.2 * dx and (x + 1) * dx are single roundings on both sides).
    assert_bf16_equal_or_neighbours(tdm, jdm, exact=True)
    assert tdbeta.dtype == torch.float32 and tdbeta.shape == (rows, D)
    np.testing.assert_allclose(tdbeta.numpy(), np.asarray(jdbeta), **SUMS)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


@pytest.mark.parametrize("act", sorted(t_rs._ACTS))
def test_act_agg_plain_versions_match_pallas(loop_graphs, interpret, act):
    """K12a and K12b on one edge type's SLICE of the type-major stream
    (ranks that do not start at 0 need a stream of whole 2048-edge rows in
    the JAX kernel; the slice of type 0 is one) and on the whole stream."""
    jg, tg = loop_graphs
    rng = np.random.RandomState(1)
    e, rows, (jm, tm), jranks = tm_stream(tg, rng, scale=1.5)
    win = WIN
    g = rng.randn(rows, D).astype(np.float32)
    jg16, tg16 = bf16_pair(g)
    for lo, hi in ((0, e), (0, 2048), (2048, e)):
        want = j_rs._act_agg_impl(jm[lo:hi], jranks[lo:hi], table_rows=rows,
                                  block_edges=256, act=act, win=win)
        got = t_rs._act_agg_impl(tm[lo:hi], tg.flat.tm_rank[lo:hi],
                                 table_rows=rows, act=act)
        assert got.dtype == torch.float32 and got.shape == (rows, D)
        if act in EXACT_ACTS:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUMS)
        else:
            # A term whose f32 activation differs in the last bit between
            # the two libraries may round to the neighbouring bf16 number:
            # 2^-8 of one term (|term| <= about 8 here) per such flip.
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=8 * 2.0 ** -8)
        jd = j_rs._act_agg_bwd_impl(jm[lo:hi], jg16, jranks[lo:hi],
                                    block_edges=256, act=act, win=win)
        td = t_rs._act_agg_bwd_impl(tm[lo:hi], tg16, tg.flat.tm_rank[lo:hi],
                                    act=act)
        assert td.shape == (hi - lo, D)
        assert_bf16_equal_or_neighbours(td, jd, exact=act in EXACT_ACTS)
    assert sum(t_rs.LAUNCHES.values()) == 0


def test_expand_add_act_and_act_aggregate_vjps_match_jax(loop_graphs,
                                                         interpret):
    """The two public functions end to end, forward and VJP, composed as
    the layer composes them: x = expand_add_act(m, beta), table =
    act_ranked_aggregate(x). Cotangents come back in the primal's dtype
    (d_m bf16, d_beta f32)."""
    jg, tg = loop_graphs
    rng = np.random.RandomState(2)
    e, rows, (jm, tm), jranks = tm_stream(tg, rng)
    win = WIN
    beta = rng.randn(rows, D).astype(np.float32)
    g = rng.randn(rows, D).astype(np.float32)

    def jfn(m, b):
        x = j_rs.expand_add_act(m, b, jranks, "relu", 256, win)
        return j_rs.act_ranked_aggregate(x, jranks, rows, "leaky_relu", 256,
                                         win)

    jout, vjp = jax.vjp(jfn, jm, jnp.asarray(beta))
    jdm, jdbeta = vjp(jnp.asarray(g))
    tm = tm.clone().requires_grad_(True)
    tbeta = torch.from_numpy(beta).requires_grad_(True)
    x = t_rs.expand_add_act(tm, tbeta, tg.flat.tm_rank, "relu")
    tout = t_rs.act_ranked_aggregate(x, tg.flat.tm_rank, rows, "leaky_relu")
    tdm, tdbeta = torch.autograd.grad(tout, (tm, tbeta), torch.from_numpy(g))
    assert jdm.dtype == jnp.bfloat16 and jdbeta.dtype == jnp.float32
    assert tdbeta.dtype == torch.float32
    # relu and leaky_relu: every term is exact on both sides.
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **SUMS)
    assert_bf16_equal_or_neighbours(tdm, jdm, exact=True)
    np.testing.assert_allclose(tdbeta.numpy(), np.asarray(jdbeta), **SUMS)


def test_act_aggregate_slices_equal_the_sum_of_whole_tables(ppi_graphs):
    """act_ranked_aggregate_slices writes every edge type's slice into one
    table; the JAX layer adds up one whole table per slice. The types'
    rank rows are disjoint, so the two agree exactly, forward and VJP."""
    _, tg = ppi_graphs
    rng = np.random.RandomState(8)
    e, rows, (_, tm), _ = tm_stream(tg, rng)
    offs = tg.flat.tm_offs
    g = torch.from_numpy(rng.randn(rows, D).astype(np.float32))
    parts = [(tm[a:b].clone().requires_grad_(True), tg.flat.tm_rank[a:b])
             for a, b in zip(offs[:-1], offs[1:])]
    assert len(parts) == 3
    one = t_rs.act_ranked_aggregate_slices(parts, rows, "gelu")
    grads_one = torch.autograd.grad(one, [m for m, _ in parts], g)
    summed = sum(t_rs.act_ranked_aggregate(m, rk, rows, "gelu")
                 for m, rk in parts)
    grads_sum = torch.autograd.grad(summed, [m for m, _ in parts], g)
    assert torch.equal(one, summed)
    for a, b in zip(grads_one, grads_sum):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    whole = t_rs.act_ranked_aggregate(tm, tg.flat.tm_rank, rows, "gelu")
    assert torch.equal(one, whole)
    with pytest.raises(ValueError):  # a table of another height
        t_rs._act_agg_impl(tm, tg.flat.tm_rank, table_rows=rows, act="gelu",
                           out=torch.zeros(rows + 1, D))


def test_edge_mlp_wrappers_check_their_arguments():
    m = torch.zeros(8, 4, dtype=torch.bfloat16)
    ranks = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_rs._expand_add_act_impl(m, torch.zeros(5, 7), ranks, act="elu")
    with pytest.raises(ValueError):  # gelu' is no function of gelu's output
        t_rs._expand_add_act_bwd_impl(m, m, ranks, table_rows=5, act="gelu")
    with pytest.raises(ValueError):
        t_rs.expand_add_act(m, torch.zeros(5, 4), ranks, "tanh")
    with pytest.raises(ValueError):
        t_rs._act_agg_impl(m, ranks[:4], table_rows=5, act="elu")
    with pytest.raises(ValueError):
        t_rs._act_agg_bwd_impl(m, torch.zeros(5, 3, dtype=torch.bfloat16),
                               ranks, act="elu")
    assert t_rs.expand_add_act_supported("ELU")
    assert not t_rs.expand_add_act_supported("gelu")
    assert t_rs.ENABLE_EMLP1_SRC_PASS is False
    assert t_rs.emlp1_src_supported("gelu", 16, 1) is False
    assert (j_rs.ENABLE_EMLP1_SRC_PASS is False
            and set(t_rs._ACTS_FROM_OUT) == set(j_rs._ACTS_FROM_OUT))


# ---- the layer ---------------------------------------------------------------

def layer_inputs(tg, hidden_layers, target, seed):
    rng = np.random.RandomState(seed)
    L = tg.num_edge_types
    sizes = [2 * D if target else D] + [D] * (hidden_layers + 1)
    params = {
        "edge_mlp": [(rng.randn(L, a, b) / np.sqrt(a)).astype(np.float32)
                     for a, b in zip(sizes[:-1], sizes[1:])],
        "ln": {"scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
               "bias": (0.1 * rng.randn(D)).astype(np.float32)},
    }
    h = rng.randn(tg.n_pad, D).astype(np.float32)
    w = rng.randn(tg.n_pad, D).astype(np.float32)
    return params, h, w


def jax_layer(jg, params, h, w, **cfg):
    weight = jnp.asarray(w) * jg.node_mask[:, None]

    def loss(p, hh):
        out = j_layers.gnn_edge_mlp_apply(p, jg, hh, **cfg)
        return jnp.sum(out * weight), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(params, jnp.asarray(h))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def torch_layer(tg, params, h, w, **cfg):
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = t_layers.gnn_edge_mlp_apply(tp, tg, th, **cfg)
    (out * torch.from_numpy(w) * tg.node_mask[:, None]).sum().backward()
    grads = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)
    return out.detach().numpy(), (grads, th.grad.numpy())


def compare_layers(tg, got, want, out_tol, grad_tol):
    out_t, (gp_t, gh_t) = got
    out_j, (gp_j, gh_j) = want
    real = tg.node_mask.numpy() > 0
    np.testing.assert_allclose(out_t[real], out_j[real], **out_tol)
    np.testing.assert_allclose(gh_t, gh_j, **grad_tol)
    leaves_t = jax.tree_util.tree_leaves(gp_t)
    leaves_j = jax.tree_util.tree_leaves(gp_j)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a, b, **grad_tol)


def compare_layers_by_norm(tg, got, want, rel):
    """Each array's difference is at most `rel` of the array's norm."""
    out_t, (gp_t, gh_t) = got
    out_j, (gp_j, gh_j) = want
    real = tg.node_mask.numpy() > 0
    pairs = [(out_t[real], out_j[real]), (gh_t, gh_j)] + list(zip(
        jax.tree_util.tree_leaves(gp_t), jax.tree_util.tree_leaves(gp_j)))
    for a, b in pairs:
        assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b)


@pytest.mark.parametrize("hidden,target,normalize,aggregation", [
    (1, True, False, "sum"), (0, True, False, "sum"), (0, True, True, "sum"),
    (1, True, True, "mean"), (2, False, False, "sum"), (1, False, True, "max"),
    (2, True, False, "sqrt_n"),
])
def test_plain_branch_matches_jax_unrolled(loop_graphs, ppi_graphs, hidden,
                                           target, normalize, aggregation):
    """The port's plain f32 branch (typed_edge_scan "unroll") against the
    JAX package's unrolled one, interpret mode off so that JAX's gather
    VJPs stay f32 segment sums: the same f32 arithmetic with other matmul
    and sum orders. Outputs are layer-normed O(1) values; gradients are
    sums over up to 20,480 edges of magnitude up to about 100."""
    cfg = dict(activation_function="gelu",
               message_aggregation_function=aggregation,
               normalize_by_num_incoming=normalize,
               use_target_state_as_input=target,
               num_edge_hidden_layers=hidden, typed_edge_scan="unroll")
    for graphs, seed in ((loop_graphs, 3), (ppi_graphs, 4)):
        jg, tg = graphs
        assert t_layers.edge_mlp_branch(
            tg, **{k: v for k, v in cfg.items()}) == "plain"
        params, h, w = layer_inputs(tg, hidden, target, seed)
        compare_layers(tg, torch_layer(tg, params, h, w, **cfg),
                       jax_layer(jg, params, h, w, **cfg),
                       dict(rtol=1e-4, atol=2e-5), dict(rtol=1e-4, atol=1e-3))


def test_configurations_without_a_kernel_branch_take_the_plain_one(
        loop_graphs):
    """Two hidden layers with the target state, normalised messages with
    a hidden layer, max aggregation or "unroll" take the plain branch; no
    target state takes the ranked one; "scan" and "always" raise."""
    _, tg = loop_graphs
    base = dict(activation_function="gelu",
                message_aggregation_function="sum",
                normalize_by_num_incoming=False,
                use_target_state_as_input=True, num_edge_hidden_layers=1,
                typed_edge_scan="auto")
    assert t_layers.edge_mlp_branch(tg, **base) == "tmajor1"
    assert t_layers.edge_mlp_branch(
        tg, **dict(base, num_edge_hidden_layers=0)) == "fused0"
    assert t_layers.edge_mlp_branch(
        tg, **dict(base, num_edge_hidden_layers=0,
                   normalize_by_num_incoming=True)) == "fused0"
    assert t_layers.edge_mlp_branch(
        tg, **dict(base, use_target_state_as_input=False)) == "ranked"
    for change in (dict(num_edge_hidden_layers=2),
                   dict(normalize_by_num_incoming=True),
                   dict(message_aggregation_function="max"),
                   dict(activation_function="selu"),
                   dict(typed_edge_scan="unroll")):
        assert t_layers.edge_mlp_branch(tg, **dict(base, **change)) == "plain"
    for scan in ("scan", "always"):
        with pytest.raises(NotImplementedError, match="typed_stream"):
            t_layers.edge_mlp_branch(tg, **dict(base, typed_edge_scan=scan))
    assert t_edge_ops.tm_available(tg)
    assert t_edge_ops.tm_self_types(tg) == (False, True)


def count_calls(monkeypatch, module, name):
    """Counts calls of module.name (looked up by the layers at call time)."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


# Kernel branch against kernel branch: the same bf16 streams and rounding
# points in both packages; the f32 matmuls in front of a bf16 cast and the
# per-type bf16 matmuls (tmajor1) sum in other orders, so a few streamed
# values land on the neighbouring bf16 number (2^-8 of one message).
# Measured: outputs (layer-normed, O(1)) within 4.3e-4, gradients (sums of
# magnitude up to about 100) within 1.6e-2, 3e-5 of their norms.
SAME_OUT = dict(rtol=1e-3, atol=2e-3)
SAME_GRAD = dict(rtol=1e-3, atol=5e-2)
# Kernel branch against the unrolled f32 branch: a bf16 stream against an
# f32 one. These are the JAX package's own limits between its kernel branch
# and its unrolled one (tests/test_ranked_segment.py).
KERNEL_OUT = dict(rtol=5e-2, atol=8e-2)
KERNEL_GRAD = dict(rtol=8e-2, atol=8e-1)


@pytest.mark.parametrize("which", ["loop", "ppi"])
def test_tmajor1_branch_matches_jax_auto(loop_graphs, ppi_graphs, interpret,
                                         monkeypatch, which):
    """The port's type-major branch (plain versions of K5a, K11, K12 on the
    CPU) against the JAX package's "auto", which takes its own type-major
    branch on these graphs (their win_tm is in (0, 64]); the self-loop type
    is combined node-side, with the doubled self edge's multiplicity."""
    jg, tg = loop_graphs if which == "loop" else ppi_graphs
    cfg = dict(activation_function="gelu", use_target_state_as_input=True,
               num_edge_hidden_layers=1, typed_edge_scan="auto")
    params, h, w = layer_inputs(tg, 1, True, seed=5)
    jcalls = count_calls(monkeypatch, j_rs, "expand_add_act")
    slices = []
    agg = t_rs._act_agg_slices_impl
    monkeypatch.setattr(t_rs, "_act_agg_slices_impl",
                        lambda s, **kw: slices.append(len(s)) or agg(s, **kw))
    want = jax_layer(jg, params, h, w, **cfg)
    got = torch_layer(tg, params, h, w, **cfg)
    # K12a: one call over every streamed type's slice.
    assert jcalls and slices == [sum(not s for s in tg.flat.tm_self)]
    compare_layers(tg, got, want, SAME_OUT, SAME_GRAD)
    # And against JAX's unrolled f32 branch, as JAX's own test does.
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", False)
    compare_layers(tg, got, jax_layer(jg, params, h, w, **dict(
        cfg, typed_edge_scan="unroll")), KERNEL_OUT, KERNEL_GRAD)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("act", ["relu", "elu"])
def test_fused0_branch_matches_jax_auto(ppi_graphs, interpret, monkeypatch,
                                        normalize, act):
    """The port's fused0 branch (the FiLM pass with gamma = 1 or 1/c per
    fine group; plain versions of K1-K3 on the CPU) against the JAX
    package's "auto", which takes its fused0 branch on this graph
    (compressive fine window)."""
    jg, tg = ppi_graphs
    cfg = dict(activation_function=act, use_target_state_as_input=True,
               num_edge_hidden_layers=0, typed_edge_scan="auto",
               normalize_by_num_incoming=normalize)
    params, h, w = layer_inputs(tg, 0, True, seed=6)
    jcalls = count_calls(monkeypatch, j_rs, "film_fused_src_pass")
    tcalls = count_calls(monkeypatch, t_rs, "film_fused_src_pass")
    want = jax_layer(jg, params, h, w, **cfg)
    got = torch_layer(tg, params, h, w, **cfg)
    assert len(jcalls) == len(tcalls) == 1
    compare_layers(tg, got, want, SAME_OUT, SAME_GRAD)
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", False)
    unrolled = jax_layer(jg, params, h, w, **dict(cfg,
                                                  typed_edge_scan="unroll"))
    if act == "relu":
        # relu has a kink: a pre-activation that the bf16 stream carries
        # across 0 flips its derivative between 0 and 1, so single
        # gradient entries move by a whole term; the arrays as wholes stay
        # within 3 % (measured up to 1.1 %).
        compare_layers_by_norm(tg, got, unrolled, 3e-2)
    else:
        compare_layers(tg, got, unrolled, KERNEL_OUT, KERNEL_GRAD)


# ---- the model -----------------------------------------------------------------

def small_params(kind, **extra):
    """The tuned QM9 hypers of GNN-Edge-MLP<kind> cut to hidden 64 and 2
    layers, dropout off (the packages' random streams cannot match)."""
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "QM9_GNN-Edge-MLP%d.json" % kind)) as f:
        hypers = json.load(f)["model_params"]
    params = j_model.GNN_Edge_MLP_Model.default_params()
    params.update(hypers)
    params.update({"hidden_size": D, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 600})
    params.update(extra)
    return params


@pytest.fixture(scope="module")
def qm9():
    """(JAX task, port task, JAX batch, port batch): first 600-node pack."""
    out = []
    for mod, base in ((j_qm9, j_base), (t_qm9, t_base)):
        task = mod.QM9_Task(mod.QM9_Task.default_params())
        data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:200]
        out.append((task, next(task.make_minibatch_iterator(
            data, base.DataFold.VALIDATION, 600))))
    (jt, jb), (tt, tb) = out
    return jt, tt, jb, tb


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """A data directory with the first graphs of each bundled QM9 fold."""
    d = tmp_path_factory.mktemp("qm9_small")
    for fold, count in (("train", 300), ("valid", 100), ("test", 150)):
        write_subset(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                     str(d / (fold + ".jsonl.gz")), count)
    return d


def test_hypers_and_defaults_equal_jax():
    for kind in (0, 1):
        name = "QM9_GNN-Edge-MLP%d.json" % kind
        with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                               name), "rb") as f:
            ported = f.read()
        with open(os.path.join(ROOT, "tf_gnn_samples_tpu", "default_hypers",
                               name), "rb") as f:
            assert ported == f.read()
    # The JAX defaults also name parallelism and caching options that the
    # port does not have yet.
    tdef = t_model.GNN_Edge_MLP_Model.default_params()
    jdef = j_model.GNN_Edge_MLP_Model.default_params()
    assert tdef == {k: jdef[k] for k in tdef}
    assert tdef["max_nodes_in_batch"] == 25000


@pytest.mark.parametrize("name", ["GNN-Edge-MLP", "gnn_edge_mlp_model",
                                  "GNN-Edge-MLP0", "gnn_edge_mlp0",
                                  "GNN-Edge-MLP1", "gnn_edge_mlp1"])
def test_registry_names_equal_jax(name):
    tcls, textra = t_registry.name_to_model_class(name)
    jcls, jextra = j_registry.name_to_model_class(name)
    assert tcls is t_model.GNN_Edge_MLP_Model
    assert jcls is j_model.GNN_Edge_MLP_Model and textra == jextra
    params = dict(tcls.default_params(), **textra)
    assert tcls.name(params) == jcls.name(params)


@pytest.mark.parametrize("scan", ["unroll", "auto"])
@pytest.mark.parametrize("kind", [0, 1])
def test_model_loss_and_gradient_norms_match_jax(qm9, tmp_path, monkeypatch,
                                                 kind, scan):
    """A 2-layer GNN-Edge-MLP<kind> on a QM9 pack, weights carried across by
    their flatten_params names. JAX runs its unrolled f32 branch either way
    (off the TPU, and QM9's rank windows are 0). With "unroll" the port
    runs its plain f32 branch too: the same arithmetic. With "auto" the
    port runs its kernel branch (fused0 / tmajor1, bf16 streams), so the
    two differ as a bf16 stream does from an f32 one and are compared by
    norms."""
    jt, tt, jb, tb = qm9
    params = small_params(kind, typed_edge_scan=scan)
    jm = j_model.GNN_Edge_MLP_Model(dict(params), jt, "j", str(tmp_path))
    tm = t_model.GNN_Edge_MLP_Model(dict(params), tt, "t", str(tmp_path),
                                    device="cpu")
    assert tm.name(params) == "GNN-Edge-MLP%d" % kind
    jflat = j_model.flatten_params(jm.model_params_tree)
    assert sorted(t_model.flatten_params(tm.model_params_tree)) == sorted(jflat)
    assert "prop/layers/1/gnn/edge_mlp/%d" % kind in jflat
    assert "prop/layers/0/gnn/ln/scale" in jflat
    tm.load_weights(jflat)
    branches = []
    pick = t_layers.edge_mlp_branch

    def recorded(*args, **kwargs):
        branches.append(pick(*args, **kwargs))
        return branches[-1]

    monkeypatch.setattr(t_layers, "edge_mlp_branch", recorded)
    tloss, _ = tm._forward(tm.model_params_tree,
                           t_model.batch_to_device(tb, CPU), None)
    want_branch = "plain" if scan == "unroll" else ("fused0", "tmajor1")[kind]
    assert branches == [want_branch] * 2
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    jdev = jm._device_batch(jb)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True)(
            jm.model_params_tree)
    jg = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    if scan == "unroll":
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   rtol=1e-5)
        for name, g in zip(names, tgrads):
            scale = float(np.abs(jg[name]).max())
            np.testing.assert_allclose(g.numpy(), jg[name], rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)
    else:
        # bf16 keeps 8 bits: values move by up to 2^-8 relative, sums of
        # them by less; two layers deep the loss and each tensor's gradient
        # norm stay within 2 %, each gradient within 5 % of its norm.
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   rtol=2e-2)
        for name, g in zip(names, tgrads):
            norm = float(np.linalg.norm(jg[name]))
            assert abs(float(g.norm()) - norm) <= 2e-2 * norm, name
            assert float(np.linalg.norm(g.numpy() - jg[name])) <= 5e-2 * norm, name


@pytest.mark.parametrize("kind", [0, 1])
def test_checkpoints_cross_packages(qm9, small_data, tmp_path, kind):
    """A JAX-written GNN-Edge-MLP pickle loads into the port (which then
    gives the same test loss on its plain branch) and the port's pickle
    loads back into JAX: same names, shapes, and the parameterised model
    name."""
    jt = qm9[0]
    test_file = str(small_data / "test.jsonl.gz")
    jm = j_model.GNN_Edge_MLP_Model(
        small_params(kind, typed_edge_scan="unroll"), jt, "j", str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))

    def eval_loss(model, base):
        data = model.task.load_eval_data_from_path(test_file)
        return model._run_epoch("Test", data, base.DataFold.TEST,
                                quiet=True)[0]

    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    assert type(tm) is t_model.GNN_Edge_MLP_Model
    assert tm.params["num_edge_hidden_layers"] == kind
    jloss = eval_loss(jm, j_base)
    np.testing.assert_allclose(eval_loss(tm, t_base), jloss, rtol=1e-5)
    tm.save_model(str(tmp_path / "torch.pickle"))
    with open(tmp_path / "torch.pickle", "rb") as f:
        saved = pickle.load(f)
    assert saved["model_class"] == "GNN-Edge-MLP%d" % kind
    jflat = j_model.flatten_params(jm.model_params_tree)
    assert saved["weights"].keys() == jflat.keys()
    for k, v in saved["weights"].items():
        assert np.array_equal(v, np.asarray(jflat[k])), k
    jm2 = j_registry.restore(str(tmp_path / "torch.pickle"), str(tmp_path))
    np.testing.assert_allclose(eval_loss(jm2, j_base), jloss, rtol=1e-6)


@pytest.mark.parametrize("model", ["GNN-Edge-MLP0", "GNN-Edge-MLP1"])
def test_train_and_test_clis(small_data, tmp_path, model):
    """`python -m tf_gnn_samples_torch.train GNN-Edge-MLP<k> QM9 --device
    cpu` takes the kernel branch (plain versions on the CPU), writes the
    log lines the bench scripts parse and a checkpoint under the
    parameterised name that the test CLI restores."""
    overrides = json.dumps({"max_epochs": 1, "hidden_size": 16,
                            "graph_num_layers": 2,
                            "max_nodes_in_batch": 2000})
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", model, "QM9",
         "--device", "cpu", "--data-path", str(small_data), "--result-dir",
         str(tmp_path), "--quiet", "--model-param-overrides", overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = r" %s: loss: \d+\.\d{5} \|\| MAEs: 0:\d+\.\d{5} \| Error Ratios: " \
           r"0:\d+\.\d{5} \|\| graphs/sec: \d+\.\d{2} \| nodes/sec: \d+ \| " \
           r"edges/sec: \d+$"
    lines = out.stdout.splitlines()
    assert any(re.match(line % "Train", l) for l in lines), out.stdout
    assert any(re.match(line % "Valid", l) for l in lines), out.stdout
    assert any("QM9_%s.json" % model in l for l in lines), out.stdout
    pickles = list(tmp_path.glob("QM9_%s_*_best_model.pickle" % model))
    assert len(pickles) == 1
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickles[0]),
         str(small_data / "test.jsonl.gz")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^Loss \d+\.\d{5} on 150 graphs$", out.stdout, re.M)


def test_cli_raises_without_a_gpu_unless_asked_for_the_cpu(small_data,
                                                           tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "GNN-Edge-MLP1",
         "QM9", "--data-path", str(small_data), "--result-dir", str(tmp_path),
         "--quiet", "--model-param-overrides", '{"max_epochs": 1}'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "No CUDA device" in out.stderr
