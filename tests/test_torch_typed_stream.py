"""The port's per-type scan (ops/typed_stream.py: stack_edges,
scan_types_wanted, scan_types_aggregate, and the scanned branches of
RGIN, GNN-Edge-MLP and RGDCN) against the JAX package's, on the CPU, on
the cases of tests/test_typed_stream.py: the same numpy graph and
weights through both packages' "scan" branch, outputs and gradients
compared. The JAX side runs no Pallas kernel here (the scan is XLA), and
the port's is plain f32 PyTorch, so the two are the same f32 arithmetic
with other sum orders: outputs within rtol 2e-5 / atol 2e-6, gradients
within rtol 1e-4 / atol 1e-5 (test_typed_stream.py holds JAX's scan to
its unrolled branch at 2e-5 / 2e-6 and 5e-5 / 5e-6).

tests/test_typed_stream.py's test_compile_graph_size_independent_of_type
_count is about the size of XLA's traced graph; eager PyTorch builds no
such graph, so it has no counterpart here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import random_typed_graph
from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import graph as j_graph
from tf_gnn_samples_tpu.ops import typed_stream as j_ts
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.ops import typed_stream as t_ts

DIM = 8
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run small tensors: with one intra-op thread a worker of
    the parallel test run does not oversubscribe the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batches(num_edge_types=5, num_nodes=17, seed=7):
    """(JAX batch, port batch) of one random graph, as test_typed_stream.py
    draws them."""
    feats, adj = random_typed_graph(np.random.default_rng(seed),
                                    num_nodes=num_nodes,
                                    num_edge_types=num_edge_types,
                                    feat_dim=DIM)
    gids = np.zeros(num_nodes, np.int32)
    return (j_graph.pad_graph_batch(feats, adj, gids, 1),
            t_graph.pad_graph_batch(feats, adj, gids, 1))


def loss_of(out, lib):
    return lib.sum(lib.sin(out) * lib.cos(out * 0.5))


def jax_run(apply_fn, params, jb, **kw):
    def loss(p, x):
        out = apply_fn(p, jb, x, **kw)
        return loss_of(out, jnp), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jb.node_features)
    return np.asarray(out), jax.tree_util.tree_leaves(grads)


def torch_run(apply_fn, params, tb, **kw):
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), params)
    h = tb.node_features.clone().requires_grad_(True)
    out = apply_fn(tp, tb, h, **kw)
    loss_of(out, torch).backward()
    grads = [t.grad for t in jax.tree_util.tree_leaves(tp)] + [h.grad]
    return out.detach().numpy(), [g.numpy() for g in grads]


def assert_scan_matches_jax(name, init_kw=None, num_edge_types=5, **kw):
    """The port's and the JAX package's `name` layer on the same graph and
    the same (JAX-initialised) weights, both at typed_edge_scan "scan"."""
    jb, tb = batches(num_edge_types)
    init, j_apply = getattr(j_layers, name + "_init"), getattr(
        j_layers, name + "_apply")
    params = jax.tree_util.tree_map(np.asarray, init(
        jax.random.key(3), num_edge_types, DIM, **(init_kw or {})))
    kw = dict(kw, typed_edge_scan=kw.get("typed_edge_scan", "scan"))
    jout, jgrads = jax_run(j_apply, params, jb, **kw)
    tout, tgrads = torch_run(getattr(t_layers, name + "_apply"), params, tb,
                             **kw)
    np.testing.assert_allclose(tout, jout, **OUT_TOL)
    assert len(tgrads) == len(jgrads)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)


def test_stack_edges_invariants():
    """The port's blocks equal the JAX package's stacked ones (senders,
    receivers, mask, norm_scale), each row's receivers sorted with its
    padding (n_pad) last, and each type's own padded length kept."""
    jb, tb = batches()
    jte, tte = j_ts.stack_edges(jb), t_ts.stack_edges(tb)
    em = max(e.senders.shape[0] for e in jb.edges)
    assert tte.senders.shape == (tb.num_edge_types, em)
    assert tte.e_pads == tuple(e.senders.shape[0] for e in jb.edges)
    for field in ("senders", "receivers", "mask", "norm_scale"):
        np.testing.assert_array_equal(getattr(tte, field).numpy(),
                                      np.asarray(getattr(jte, field)),
                                      err_msg=field)
    for l in range(tb.num_edge_types):
        block = t_ts.type_block(tte, l)
        rcv = block.receivers.numpy()
        assert (np.diff(rcv) >= 0).all()
        assert block.senders.shape[0] == tte.e_pads[l]
        pad = block.mask.numpy() == 0
        assert (rcv[pad] == tb.n_pad).all() and (
            block.senders.numpy()[pad] == tb.n_pad).all()


@pytest.mark.parametrize("aggregation", ["sum", "mean", "max", "sqrt_n"])
def test_rgin_scan_matches_jax(aggregation):
    assert_scan_matches_jax("rgin", message_aggregation_function=aggregation,
                            num_timesteps=2)


def test_rgin_scan_target_state_input():
    assert_scan_matches_jax(
        "rgin", dict(use_target_state_as_input=True,
                     num_edge_MLP_hidden_layers=2),
        use_target_state_as_input=True, num_edge_MLP_hidden_layers=2)


@pytest.mark.parametrize("normalize", [False, True])
def test_edge_mlp_scan_matches_jax(normalize):
    assert_scan_matches_jax("gnn_edge_mlp",
                            normalize_by_num_incoming=normalize,
                            num_timesteps=2)


@pytest.mark.parametrize("aggregation", ["sum", "max"])
@pytest.mark.parametrize("full_state,tie", [(False, False), (True, True)])
def test_rgdcn_scan_matches_jax(full_state, tie, aggregation):
    """The aggregate-first sum branch (scanned neighbour sums, the
    contraction's sum over types from zeros) and the per-channel branch
    for max."""
    cfg = dict(num_channels=2, use_full_state_for_channel_weights=full_state,
               tie_channel_weights=tie)
    assert_scan_matches_jax("rgdcn", cfg, num_timesteps=2,
                            message_aggregation_function=aggregation, **cfg)


def test_auto_engages_on_many_types():
    """scan_types_wanted answers as the JAX package's; at "auto" with nine
    edge types the gates take the scan where no kernel branch applies, and
    the layers then equal the JAX package's at "auto"."""
    few_j, few_t = batches(num_edge_types=3)
    many_j, many_t = batches(num_edge_types=9)
    for strategy in ("auto", "scan", "always", "unroll", "never"):
        for jb, tb in ((few_j, few_t), (many_j, many_t)):
            assert t_ts.scan_types_wanted(tb, strategy) == (
                j_ts.scan_types_wanted(jb, strategy))
    assert not t_ts.scan_types_wanted(few_t, "auto")
    assert t_ts.scan_types_wanted(many_t, "auto")
    assert t_layers.rgin_branch(
        many_t, message_aggregation_function="max",
        use_target_state_as_input=False, num_edge_MLP_hidden_layers=1,
        typed_edge_scan="auto") == "scanned"
    assert t_layers.rgin_branch(
        few_t, message_aggregation_function="max",
        use_target_state_as_input=False, num_edge_MLP_hidden_layers=1,
        typed_edge_scan="auto") == "unrolled"
    assert t_layers.edge_mlp_branch(
        many_t, activation_function="relu",
        message_aggregation_function="sum", normalize_by_num_incoming=True,
        use_target_state_as_input=True, num_edge_hidden_layers=1,
        typed_edge_scan="auto", w1_dims=(DIM, DIM)) == "scanned"
    assert t_layers.rgdcn_sums_form(many_t, "segment", "auto") in (
        "fine", "scanned")
    assert_scan_matches_jax("rgin", num_edge_types=9,
                            message_aggregation_function="max",
                            typed_edge_scan="auto")
    assert_scan_matches_jax("gnn_edge_mlp", num_edge_types=9,
                            normalize_by_num_incoming=True,
                            typed_edge_scan="auto")
