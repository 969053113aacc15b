"""The port's remaining GNN-Edge-MLP pieces against the JAX package's, on
the CPU: the plain versions of K10a / K10b (typed_dense_agg) and K14
(emlp1_src_bwd) against the Pallas kernels in interpret mode, the fused
gather + segment-sum `gather_aggregate_src` with its source-order
backward, and the layer's `ranked`, `fused1` and `fused_src1` branches
against the JAX package's own.

Graphs: a numpy-made graph of four edge types and six in-edges per
receiver and type (its fine and type-major windows are 64, within the JAX
gates' (0, 64], its src stream dilutes, and each type's slice of the
type-major stream is a whole number of 2048-edge rows), and a QM9 pack
(undiluted)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import edge_ops as j_edge_ops
from tf_gnn_samples_tpu.ops import graph as j_graph
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import edge_ops as t_edge_ops
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

from test_torch_edge_mlp import (SAME_GRAD, SAME_OUT, bf16_pair,
                                 compare_layers, count_calls, f32, jax_layer,
                                 torch_layer)

D = 64  # at 64 columns JAX's gather VJPs are ranked kernels, as the port's
DK = 32  # the width of the kernel-level tests


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


def multitype_graph(seed=0, n=500, types=4, degree=6):
    """`degree` random in-edges per node and type: (features, adjacency
    lists, graph ids)."""
    rng = np.random.RandomState(seed)
    adj = []
    for _ in range(types):
        dst = np.repeat(np.arange(n), degree)
        src = rng.randint(0, n, size=dst.shape[0])
        adj.append(np.stack([src, dst], 1).astype(np.int32))
    return (rng.randn(n, 8).astype(np.float32), adj,
            np.zeros(n, np.int32))


@pytest.fixture(scope="module")
def multi():
    """(JAX batch, port batch) of multitype_graph: E = 16,384."""
    feats, adj, gids = multitype_graph()
    e_pads = [-(-a.shape[0] // 2048) * 2048 for a in adj]
    jg = j_graph.pad_graph_batch(feats, adj, gids, 1, e_pads=e_pads)
    tg = t_graph.pad_graph_batch(feats, adj, gids, 1, e_pads=e_pads)
    flat = tg.flat
    assert 0 < flat.win_fine <= 64 and 0 < flat.win_tm <= 64
    assert flat.win_sd and (flat.sd_fine == int(t_graph.SD_FILL)).any()
    assert all(b % t_rs.STEP == 0 for b in flat.tm_offs)
    assert flat.tm_self == (False,) * 4
    return jg, tg


@pytest.fixture(scope="module")
def qm9():
    """(JAX batch, port batch) of the first 600-node QM9 pack (undiluted)."""
    out = []
    for mod, base in ((j_qm9, j_base), (t_qm9, t_base)):
        task = mod.QM9_Task(mod.QM9_Task.default_params())
        data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:200]
        out.append(next(task.make_minibatch_iterator(
            data, base.DataFold.VALIDATION, 600)).graph)
    assert out[1].flat.win_sd == 0
    return tuple(out)


def i32(t):
    return jnp.asarray(t.numpy())


# ---- K10: the typed dense aggregate ------------------------------------

def typed_stream(seed, e=2048, n_real=150, types=3, dh=DK, d=DK):
    """A receiver-sorted stream with gap-free ranks and a padded tail on
    the dump rank, random types (a few out of range: they add nothing),
    bf16 x, bf16 weights of unit-scale products and a bf16 cotangent."""
    rng = np.random.RandomState(seed)
    n = int(e * 0.9)
    _, rank = np.unique(np.sort(rng.randint(0, n_real, size=n)),
                        return_inverse=True)
    ranks = np.full(e, rank[-1] + 1, np.int32)
    ranks[:n] = rank
    kinds = rng.randint(0, types, size=e).astype(np.int32)
    kinds[::97] = types  # no such type
    rows = t_rs.rank_table_rows(n_real, 256)
    x = bf16_pair(rng.randn(e, dh).astype(np.float32))
    w = bf16_pair((rng.randn(types, dh, d) / np.sqrt(dh)).astype(np.float32))
    g = bf16_pair(rng.randn(rows, d).astype(np.float32))
    return ranks, kinds, rows, x, w, g


@pytest.mark.parametrize("act", ["relu", "elu", "gelu"])
def test_typed_dense_agg_plain_versions_match_pallas(act):
    """K10a and K10b. Both sides form each edge's product x_e @ W[type_e]
    from the same bf16 operands in f32 (the TPU kernel as L masked MXU
    products, the plain version per type), in other orders: a product may
    differ in its last f32 bits, and then its bf16-rounded term (K10a) or
    dz (K10b) may land on the neighbouring bf16 number. Forward: rows are
    f32 sums of bf16 terms, within 1e-5 of their scale plus one bf16 ulp of
    the largest term (2^-8 * 8). dx: bf16 values, equal or within the
    change one such dz makes (2^-8 * |dz| * |W| summed, below 2^-6 here);
    dW: f32 sums of exact products x * dz, within 1e-5 of the array's scale
    plus what one flipped dz moves an entry by (|x| * 2^-8 |dz| <= 2^-4
    here), and within 1e-4 of its norm."""
    ranks, kinds, rows, (jx, tx), (jw, tw), (jg16, tg16) = typed_stream(3)
    jr, jt = jnp.asarray(ranks), jnp.asarray(kinds)
    tr, tt = torch.from_numpy(ranks), torch.from_numpy(kinds)
    want = np.asarray(j_rs._typed_dense_agg_impl(
        jx, jw, jt, jr, table_rows=rows, block_edges=256, act=act))
    got = t_rs._typed_dense_agg_impl(tx, tw, tt, tr, table_rows=rows, act=act)
    assert got.dtype == torch.float32 and got.shape == (rows, DK)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max() + 2.0 ** -5)
    jdx, jdw = j_rs._typed_dense_agg_bwd_impl(jx, jw, jg16, jt, jr,
                                              block_edges=256, act=act)
    tdx, tdw = t_rs._typed_dense_agg_bwd_impl(tx, tw, tg16, tt, tr, act=act)
    assert tdx.dtype == torch.bfloat16 and tdx.shape == (2048, DK)
    assert tdw.dtype == torch.float32 and tdw.shape == (3, DK, DK)
    np.testing.assert_allclose(f32(tdx), f32(jdx), rtol=2.0 ** -7,
                               atol=2.0 ** -6)
    assert (f32(tdx) != f32(jdx)).mean() < 1e-3
    assert (f32(tdx)[kinds == 3] == 0).all()
    jdw = np.asarray(jdw)
    np.testing.assert_allclose(tdw.numpy(), jdw, rtol=1e-5,
                               atol=1e-5 * np.abs(jdw).max() + 2.0 ** -4)
    assert np.linalg.norm(tdw.numpy() - jdw) <= 1e-4 * np.linalg.norm(jdw)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


# ---- K14: the Edge-MLP1 source-order recompute --------------------------

def src_pass_inputs(tg, seed, diluted):
    """K14's inputs as the fused backward builds them, over the src stream
    (undiluted, or the diluted one with zero side rows at its fill slots):
    a bf16 beta | g stream [E, 2D], a bf16 t table over src ranks, each src
    rank's compact non-self type (here all four types stream) as the
    port's int column and the JAX package's one-hot, and the weights."""
    flat = tg.flat
    rng = np.random.RandomState(seed)
    ranks = flat.sd_rank if diluted else flat.src_sorted_rank
    e, rsrc = ranks.shape[0], flat.src_from_rank.shape[0]
    gcb = rng.randn(e, 2 * DK).astype(np.float32)
    if diluted:
        gcb[flat.sd_fine.numpy() == int(t_graph.SD_FILL)] = 0.0
    t = rng.randn(rsrc, DK).astype(np.float32)
    w = (rng.randn(4, DK, DK) / np.sqrt(DK)).astype(np.float32)
    cols = t_rs.src_rank_type_columns(flat.src_from_rank, tg.n_pad,
                                      flat.tm_self).numpy()
    onehot = (cols[:, None] == np.arange(4)[None]).astype(np.float32)
    e_real = e - 300  # the last 300 slots stand for the padded tail
    return ranks, rsrc, gcb, t, w, cols, onehot, e_real


@pytest.mark.parametrize("diluted", [False, True])
def test_emlp1_src_bwd_plain_matches_pallas(multi, diluted):
    """K14 against _emlp1_src_bwd_impl in interpret mode. Per edge both
    recompute x = elu(m + beta) in f32, y = bf16(x) @ W (f32 sums, other
    orders), da = bf16(act'(y) * g), dx = da @ W^T and dm = elu'(x) * dx,
    rounded to bf16 and summed in f32 per src rank. A y or dx that differs
    in its last f32 bits may carry da or dm to the neighbouring bf16
    number: each row is held to 2^-6 of its sum of |term| (a flip of da
    moves dm by 2^-8 |da| |W| summed over D) plus 1e-5 for the sum order.
    Slots at or past e_real, and fill slots, add nothing."""
    jg, tg = multi
    ranks, rsrc, gcb, t, w, cols, onehot, e_real = src_pass_inputs(
        tg, 6, diluted)
    (jgcb, tgcb), (jt, tt), (jw, tw) = bf16_pair(gcb), bf16_pair(t), \
        bf16_pair(w)
    want = np.asarray(j_rs._emlp1_src_bwd_impl(
        jgcb, jt, jnp.asarray(onehot).astype(jnp.bfloat16), jw,
        jnp.swapaxes(jw, 1, 2), jnp.asarray([e_real], jnp.int32), i32(ranks),
        table_rows=rsrc, block_edges=256, act="gelu"))
    got = t_rs._emlp1_src_bwd_impl(
        tgcb, tt, torch.from_numpy(cols), tw,
        torch.tensor([e_real], dtype=torch.int32), ranks, table_rows=rsrc,
        act="gelu")
    assert got.dtype == torch.float32 and got.shape == (rsrc, DK)
    got = got.numpy()
    # Per-row sum of |term|: the plain version with every edge a rank of
    # its own (and its own row of t and of the type column).
    e = ranks.shape[0]
    every = torch.arange(e, dtype=torch.int32)
    per_edge = t_rs._emlp1_src_bwd_plain(
        tgcb, tt.index_select(0, ranks), torch.from_numpy(cols)[ranks.long()],
        tw, torch.tensor([e_real], dtype=torch.int32), every, e,
        "gelu").numpy()
    terms_abs = np.zeros((rsrc, DK))
    np.add.at(terms_abs, ranks.numpy(), np.abs(per_edge))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= (2.0 ** -6 + 1e-5) * terms_abs + 1e-30).all()
    assert (per_edge[e_real:] == 0).all() and np.abs(got).max() > 0
    fed = np.zeros(rsrc, bool)
    fed[ranks.numpy()[:e_real]] = True
    assert (got[~fed] == 0).all() and (want[~fed] == 0).all()
    assert sum(t_rs.LAUNCHES.values()) == 0


# ---- the fused gather + segment-sum ---------------------------------------

@pytest.mark.parametrize("which", ["qm9", "multi"])
def test_gather_aggregate_src_matches_jax(qm9, multi, which):
    """Forward and VJP of gather_aggregate_src on an undiluted (QM9) and a
    diluted src stream: the same bf16 table rows summed in f32 per
    receiver, and the table cotangent rounded to bf16 and summed per src
    rank; both sides add the same bf16 terms in other orders."""
    jg, tg = qm9 if which == "qm9" else multi
    assert bool(tg.flat.win_sd) == (which == "multi")
    assert t_edge_ops.gather_aggregate_src_ok(tg, "sum")
    rng = np.random.RandomState(7)
    rows = tg.num_edge_types * tg.n_pad
    jtab, ttab = bf16_pair(rng.randn(rows, D).astype(np.float32))
    g = rng.randn(tg.n_pad, D).astype(np.float32)
    for aggregation in ("sum", "mean"):
        jout, vjp = jax.vjp(lambda tab: j_edge_ops.gather_aggregate_src(
            tab, jg, aggregation), jtab)
        (jd,) = vjp(jnp.asarray(g))
        tin = ttab.clone().requires_grad_(True)
        tout = t_edge_ops.gather_aggregate_src(tin, tg, aggregation)
        (td,) = torch.autograd.grad(tout, tin, torch.from_numpy(g))
        assert td.dtype == torch.bfloat16 and td.shape == (rows, D)
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
        # d is rounded to the table's bf16 from f32 sums in two orders.
        np.testing.assert_allclose(f32(td), f32(jd), rtol=2.0 ** -7,
                                   atol=1e-6)


# ---- the layer's branches -------------------------------------------------

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


def without_type_major(graph):
    """The batch with its type-major view withheld (tm_rank None)."""
    return graph._replace(flat=graph.flat._replace(tm_rank=None))


@pytest.mark.parametrize("normalize", [False, True])
def test_ranked_branch_matches_jax_auto(multi, monkeypatch, normalize):
    """No target state: the MLP on the node tables and one ranked
    aggregation, through the fused gather + segment-sum (unnormalised) or
    the ranked gather and aggregation (1/c per edge), in both packages."""
    jg, tg = multi
    cfg = dict(activation_function="gelu", use_target_state_as_input=False,
               num_edge_hidden_layers=1, typed_edge_scan="auto",
               normalize_by_num_incoming=normalize)
    branch_cfg = dict(cfg, message_aggregation_function="sum",
                      w1_dims=(D, D))
    assert t_layers.edge_mlp_branch(tg, **branch_cfg) == "ranked"
    params, h, w = layer_inputs(tg, 1, False, seed=8)
    # The JAX package's gate: a compressive fine window and a ranked stream.
    assert j_layers.compressive_window(jg.flat)
    assert j_edge_ops.ranked_aggregation_ok(jg, "sum", 1, D)
    name = "aggregate_flat_ranked" if normalize else "gather_aggregate_src"
    tcalls = count_calls(monkeypatch, t_layers, name)
    want = jax_layer(jg, params, h, w, **cfg)
    got = torch_layer(tg, params, h, w, **cfg)
    assert len(tcalls) == 1
    compare_layers(tg, got, want, SAME_OUT, SAME_GRAD)


def test_fused1_branch_matches_jax_auto(multi, monkeypatch):
    """The tuned GNN-Edge-MLP1 configuration on a batch without the
    type-major view: the typed dense aggregate (plain versions of K10a /
    K10b on the CPU) against the JAX package's fused1 branch."""
    jg, tg = (without_type_major(g) for g in multi)
    cfg = dict(activation_function="gelu", use_target_state_as_input=True,
               num_edge_hidden_layers=1, typed_edge_scan="auto")
    assert not t_edge_ops.tm_available(tg) and not j_edge_ops.tm_available(jg)
    assert t_layers.edge_mlp_branch(
        tg, message_aggregation_function="sum",
        normalize_by_num_incoming=False, w1_dims=(D, D), **cfg) == "fused1"
    params, h, w = layer_inputs(tg, 1, True, seed=9)
    jcalls = count_calls(monkeypatch, j_rs, "typed_dense_aggregate")
    tcalls = count_calls(monkeypatch, t_rs, "typed_dense_aggregate")
    want = jax_layer(jg, params, h, w, **cfg)
    got = torch_layer(tg, params, h, w, **cfg)
    assert jcalls and len(tcalls) == 1
    compare_layers(tg, got, want, SAME_OUT, SAME_GRAD)


def test_fused_src1_branch_matches_jax_auto(multi, monkeypatch):
    """ENABLE_EMLP1_SRC_PASS on in both packages: the type-major branch
    takes the source-order recompute (the plain version of K14 here) in
    place of the type-major gather's backward, against the JAX package's
    fused_src1 (whose own tests hold it against its tmajor1)."""
    jg, tg = multi
    cfg = dict(activation_function="gelu", use_target_state_as_input=True,
               num_edge_hidden_layers=1, typed_edge_scan="auto")
    params, h, w = layer_inputs(tg, 1, True, seed=10)
    monkeypatch.setattr(j_rs, "ENABLE_EMLP1_SRC_PASS", True)
    monkeypatch.setattr(t_rs, "ENABLE_EMLP1_SRC_PASS", True)
    assert t_rs.emlp1_src_supported("gelu", D, 4)
    assert not t_rs.emlp1_src_supported("gelu", D, 5)
    jcalls = count_calls(monkeypatch, j_rs, "emlp1_tm_pass")
    tcalls = count_calls(monkeypatch, t_rs, "emlp1_tm_pass")
    want = jax_layer(jg, params, h, w, **cfg)
    got = torch_layer(tg, params, h, w, **cfg)
    assert jcalls and len(tcalls) == 1
    compare_layers(tg, got, want, SAME_OUT, SAME_GRAD)


def test_gates_and_flag_defaults(multi):
    """The flag is off by default in both packages; the gates keep their
    semantic terms."""
    _, tg = multi
    assert t_rs.ENABLE_EMLP1_SRC_PASS is False
    assert j_rs.ENABLE_EMLP1_SRC_PASS is False
    assert not t_rs.emlp1_src_supported("gelu", D, 4)
    assert t_rs.typed_dense_agg_supported(8, "gelu", D, D)
    assert not t_rs.typed_dense_agg_supported(9, "gelu", D, D)
    assert not t_rs.typed_dense_agg_supported(4, "selu", D, D)
    base = dict(activation_function="gelu",
                message_aggregation_function="sum",
                normalize_by_num_incoming=False,
                use_target_state_as_input=True, num_edge_hidden_layers=1,
                typed_edge_scan="auto", w1_dims=(D, D))
    assert t_layers.edge_mlp_branch(tg, **base) == "tmajor1"
    assert t_layers.edge_mlp_branch(without_type_major(tg), **base) == "fused1"
    assert t_layers.edge_mlp_branch(
        without_type_major(tg), **dict(base, normalize_by_num_incoming=True)
    ) == "plain"
    assert t_layers.edge_mlp_branch(
        tg, **dict(base, use_target_state_as_input=False,
                   message_aggregation_function="mean")) == "ranked"
    assert t_layers.edge_mlp_branch(
        tg, **dict(base, use_target_state_as_input=False,
                   message_aggregation_function="max")) == "plain"


@pytest.mark.parametrize("width", [64, 176])
def test_fused1_takes_only_widths_the_kernels_hold(multi, monkeypatch,
                                                   width):
    """The tuned GNN-Edge-MLP1 configuration on a batch without the
    type-major view takes fused1 (K10) at D 64 and the plain branch at
    D 176, past K10b's shared memory (typed_dense_agg_fits), so a wide
    config trains a step and never reaches the wrapper's refusal on the
    card."""
    _, tg = multi
    tg = without_type_major(tg)
    calls = count_calls(monkeypatch, t_rs, "typed_dense_aggregate")
    rng = np.random.RandomState(width)
    num_types = tg.num_edge_types
    params = {
        "edge_mlp": [torch.from_numpy(
            (rng.randn(num_types, a, width) / np.sqrt(a)).astype(np.float32))
            for a in (2 * width, width)],
        "ln": {"scale": torch.ones(width), "bias": torch.zeros(width)}}
    for p in params["edge_mlp"]:
        p.requires_grad_(True)
    h = torch.from_numpy(rng.randn(tg.n_pad, width).astype(np.float32))
    fits = width <= 160
    assert t_rs.typed_dense_agg_fits(num_types, width, width, True) == fits
    assert t_rs.typed_dense_agg_supported(num_types, "gelu", width,
                                          width) == fits
    assert t_layers.edge_mlp_branch(
        tg, activation_function="gelu", message_aggregation_function="sum",
        normalize_by_num_incoming=False, use_target_state_as_input=True,
        num_edge_hidden_layers=1, typed_edge_scan="auto",
        w1_dims=(width, width)) == ("fused1" if fits else "plain")
    out = t_layers.gnn_edge_mlp_apply(
        params, tg, h, activation_function="gelu",
        use_target_state_as_input=True, num_edge_hidden_layers=1,
        typed_edge_scan="auto")
    out.square().mean().backward()
    assert len(calls) == fits
    with torch.no_grad():
        for p in params["edge_mlp"]:
            assert bool(torch.isfinite(p.grad).all()) and p.grad.abs().max() > 0
            p -= 0.01 * p.grad


def test_new_wrappers_check_their_arguments():
    bf = dict(dtype=torch.bfloat16)
    ranks = torch.zeros(8, dtype=torch.int32)
    kinds = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):  # W rows != x columns
        t_rs._typed_dense_agg_impl(torch.zeros(8, 4, **bf),
                                   torch.zeros(2, 5, 3, **bf), kinds, ranks,
                                   table_rows=4, act="relu")
    with pytest.raises(ValueError):  # cotangent of another width
        t_rs._typed_dense_agg_bwd_impl(torch.zeros(8, 4, **bf),
                                       torch.zeros(2, 4, 3, **bf),
                                       torch.zeros(4, 5, **bf), kinds, ranks,
                                       act="relu")
    with pytest.raises(ValueError):  # the stream is not 2D wide
        t_rs._emlp1_src_bwd_impl(
            torch.zeros(8, 6, **bf), torch.zeros(4, 4, **bf),
            torch.zeros(4, dtype=torch.int32), torch.zeros(1, 4, 4, **bf),
            torch.tensor([8], dtype=torch.int32), ranks, table_rows=4,
            act="relu")
    assert {"typed_dense_agg", "typed_dense_agg_bwd",
            "emlp1_src_bwd"} <= set(t_rs.LAUNCHES)
