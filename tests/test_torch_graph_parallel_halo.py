"""The port's halo exchange (tf_gnn_samples_torch/parallel/
graph_parallel.py: partition_graph_halo, the all-to-all Function,
GP_HALO_LAYERS and the two bare halo layers) against the JAX package's
and against the port's single-process layers, on the CPU: four gloo ranks
started once by parallel/_multihost_check.py (kind halo_layers) at a
file:// rendezvous under the test's temporary directory, each running
tests/test_graph_parallel.py's nine halo cases and the two bare layers on
its partition of a 90-node random typed graph (uneven partitions: 24, 24,
24 and 18 real nodes); JAX runs the same layers on 4 of the 8 virtual CPU
devices. Also the local half computed while every all-to-all's receive
buffer holds NaN until its wait(), an edge planted on a padded halo slot,
and the host partitioner against the JAX package's, each partition built
alone too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tf_gnn_samples_tpu.nn.layers import LAYERS as J_LAYERS
from tf_gnn_samples_tpu.parallel import graph_parallel as j_gp
from tf_gnn_samples_tpu.parallel.data_parallel import make_mesh
from tf_gnn_samples_tpu.runtime.model import unflatten_like
from tf_gnn_samples_torch.parallel import _multihost_check as check
from tf_gnn_samples_torch.parallel import graph_parallel as gp

RANKS = 4
CASES = [c[0] for c in check.HALO_LAYER_CASES + check.HALO_BARE_CASES]
# tests/test_graph_parallel.py's layer bar.
LAYER_TOL = dict(rtol=3e-4, atol=2e-4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the four ranks saw (rank r's file)."""
    out = tmp_path_factory.mktemp("halo_layers")
    line = check.run_multihost_check(RANKS, out_dir=str(out),
                                     kind="halo_layers")
    assert "MULTIHOST_OK processes=4" in line and "kind=halo_layers" in line
    return [torch.load(str(out / ("rank%d.pt" % r)), weights_only=False)
            for r in range(RANKS)]


def jax_halo_layer(case, params):
    """The JAX package's counterpart of the case's layer, on a shard."""
    if case == "bare rgcn":
        return lambda sh: j_gp.gp_halo_rgcn_layer(
            params["W"], sh, sh.node_features + 0.0, "gp", jax.nn.relu)
    if case == "bare gnn_film":
        return lambda sh: j_gp.gp_film_halo_layer(
            params, sh, sh.node_features + 0.0, "gp",
            activation_function="relu")
    layer, _, apply_kw, _ = check.halo_case_spec(case)
    return lambda sh: j_gp.GP_HALO_LAYERS[layer](
        params, sh, sh.node_features + 0.0, "gp", **apply_kw)


@pytest.mark.parametrize("case", CASES)
def test_halo_layer_matches_jax_and_the_single_process_layer(case, ranks):
    """The 4-rank halo layer's gathered output against the JAX package's
    (GP_HALO_LAYERS, or its bare gp_halo_rgcn_layer / gp_film_halo_layer)
    on 4 virtual devices, same graph and weights, and against the port's
    single-process layer on the whole graph (the f32 plain branches),
    within rtol 3e-4 / atol 2e-4; its gradients (of sum(output * R),
    summed over the ranks) for the parameters and the input states
    against the single-process layer's; every rank's halo_pad the JAX
    partitioner's, below the node count."""
    rec = ranks[0]["layers"][case]
    layer, init_kw, _, seed = check.halo_case_spec(case)
    feats, adj = check.random_typed_graph(check.GP_LAYER_NODES, seed=seed)
    n, d = feats.shape
    template = J_LAYERS[layer][0](jax.random.PRNGKey(0), len(adj), d,
                                  **init_kw)
    params = unflatten_like(template, rec["params"])
    shards, _, n_global, halo_pad = j_gp.partition_graph_halo(feats, adj,
                                                              RANKS)
    assert all(r["layers"][case]["halo_pad"] == halo_pad for r in ranks)
    assert halo_pad < n
    fn = jax_halo_layer(case, params)

    def fwd(shard):
        return fn(jax.tree_util.tree_map(lambda x: x[0], shard))[None]

    sharded = shard_map(fwd, mesh=make_mesh(RANKS, axis_name="gp"),
                        in_specs=(P("gp"),), out_specs=P("gp"),
                        check_vma=False)
    want = np.asarray(jax.jit(sharded)(jax.tree_util.tree_map(
        jnp.asarray, shards))).reshape(n_global, d)[:n]
    got, single = rec["split"], rec["single"]
    np.testing.assert_allclose(got["out"], want, **LAYER_TOL)
    np.testing.assert_allclose(got["out"], single["out"], **LAYER_TOL)
    for g, s in zip(got["grads"], single["grads"]):
        np.testing.assert_allclose(g, s, **LAYER_TOL)
    np.testing.assert_allclose(got["grad_h"], single["grad_h"], **LAYER_TOL)
    assert max(float(np.abs(g).max()) for g in got["grads"]) > 0


@pytest.mark.parametrize("case", CASES)
def test_local_half_reads_no_halo_rows_before_the_wait(case, ranks):
    """The layer run again with every all-to-all's receive buffer NaN
    until its wait(): the same output and gradients bit for bit, so the
    local stream (and, for the bare layers, everything) read the buffer
    only after the wait."""
    rec = ranks[0]["layers"][case]
    held, split = rec["held"], rec["split"]
    assert np.isfinite(held["out"]).all()
    assert np.array_equal(held["out"], split["out"])
    assert np.array_equal(held["grad_h"], split["grad_h"])
    assert all(np.array_equal(a, b) for a, b in zip(held["grads"],
                                                     split["grads"]))


def test_an_edge_on_a_padded_halo_slot_fails_the_layer_check(ranks):
    """Rank 0's first remote RGCN edge moved onto a padded halo slot
    (filled from the sender's row 0): the output and the input states'
    gradients leave the single-process layer's tolerance, so no real
    edge may read a padded slot and none may send a gradient to row 0
    through one."""
    rec = ranks[0]["layers"]["rgcn"]
    planted, single = rec["padded_slot"], rec["single"]
    assert planted["planted"]
    assert not np.allclose(planted["out"], single["out"], **LAYER_TOL)
    assert not np.allclose(planted["grad_h"], single["grad_h"], **LAYER_TOL)
    np.testing.assert_allclose(rec["split"]["out"], single["out"],
                               **LAYER_TOL)


def assert_halo_shard_equal(got, want, p):
    for name in gp.GPHaloShard._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, gp.GPFlatEdges):
            for field in gp.GPFlatEdges._fields:
                assert np.array_equal(getattr(a, field), np.asarray(
                    getattr(b, field))[p]), (p, name, field)
        else:
            assert np.array_equal(a, np.asarray(b)[p]), (p, name)


def chain_graph(n, parts, seed):
    """Typed edges only between nodes of the same or of neighbouring
    contiguous partitions (of n // parts nodes): partitions 0 and 2 share
    no boundary."""
    rng = np.random.RandomState(seed)
    size = n // parts
    adj = []
    for _ in range(3):
        src = rng.randint(0, n, size=2 * n)
        rcv = np.clip(src + rng.randint(-size // 2, size // 2 + 1, size=2 * n),
                      0, n - 1)
        adj.append(np.stack([src, rcv], axis=1).astype(np.int32))
    return rng.randn(n, 16).astype(np.float32), adj


@pytest.mark.parametrize("graph,n,parts", [
    ("random", 90, 4), ("random", 96, 4), ("random", 90, 2),
    ("random", 200, 3), ("chain", 96, 3), ("chain", 128, 4)])
def test_partition_graph_halo_matches_jax(graph, n, parts):
    """The port's halo partitioner against the JAX package's: every field
    of every partition (send lists, the merged, local and remote streams)
    equal, and n_local, n_global and halo_pad; each partition built alone
    (parts=[p]) the same piece with the same halo_pad, since halo_pad and
    the send lists come from every pair's boundary. On the chain graphs
    partitions 0 and 2 share no boundary: their send lists are empty."""
    if graph == "random":
        feats, adj = check.random_typed_graph(n, seed=n + parts)
    else:
        feats, adj = chain_graph(n, parts, seed=n)
    got, nl, ng, hp = gp.partition_graph_halo(feats, adj, parts)
    want, wnl, wng, whp = j_gp.partition_graph_halo(feats, adj, parts)
    assert (nl, ng, hp) == (wnl, wng, whp)
    assert len(got) == parts
    for p in range(parts):
        assert_halo_shard_equal(got[p], want, p)
        (alone,), _, _, alone_hp = gp.partition_graph_halo(feats, adj, parts,
                                                           parts=[p])
        assert alone_hp == hp
        assert_halo_shard_equal(alone, want, p)
    assert got[-1].node_mask.sum() == n - (parts - 1) * nl
    if graph == "chain":
        need = gp._halo_needs(gp._partition_prologue(
            feats, adj, parts, None)[3], nl, parts)
        assert len(need[0][2]) == len(need[2][0]) == 0
        assert not got[0].send_idx[2].any() and not got[2].send_idx[0].any()
        assert len(need[0][1]) and len(need[1][0])


def test_partition_task_batch_halo_matches_jax():
    """partition_task_batch_halo on a QM9 batch at the fold-static edge
    pad, measured and pinned halo_pad, against the JAX package's; a
    halo_pad pinned below the widest boundary list raises."""
    from tf_gnn_samples_tpu.tasks import base as j_base
    from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
    from tf_gnn_samples_torch.tasks import base as t_base
    from tf_gnn_samples_torch.tasks import qm9 as t_qm9

    batch = check.step_batches(check.qm9_task(t_qm9, t_base), t_base, 1)[0]
    jbatch = check.step_batches(check.qm9_task(j_qm9, j_base), j_base, 1)[0]
    budget = gp.batch_edge_budget(batch)
    for pin in (None, 64):
        got, nl, ng, hp = gp.partition_task_batch_halo(
            batch, 2, batch.graph.n_pad, budget, halo_pad_target=pin)
        want, wnl, wng, whp = j_gp.partition_task_batch_halo(
            jbatch, 2, jbatch.graph.n_pad, budget, halo_pad_target=pin)
        assert (nl, ng, hp) == (wnl, wng, whp)
        assert pin is None or hp == pin
        for p in range(2):
            assert_halo_shard_equal(got[p], want, p)
        assert got[0].src_ext.shape[0] == budget
    with pytest.raises(ValueError, match="below the widest boundary list"):
        gp.partition_task_batch_halo(batch, 2, batch.graph.n_pad, budget,
                                     halo_pad_target=1)
