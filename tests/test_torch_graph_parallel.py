"""The port's graph-parallel layers (tf_gnn_samples_torch/parallel/
graph_parallel.py) against the JAX package's GP_LAYERS and against the
port's single-process layers, on the CPU: four gloo ranks started once by
parallel/_multihost_check.py (kind gp_layers) at a file:// rendezvous
under the test's temporary directory, each running the seven families
(tests/test_graph_parallel.py's cases, and RGCN's) on its partition of a
90-node random typed graph (uneven partitions: 24, 24, 24 and 18 real
nodes); JAX runs the same layers on 4 of the 8 virtual CPU devices. Also
the source-ownership split against the merged stream, the split's local
half computed while every all-gather's output holds NaN until its wait(),
the summed gradients against the single-process layer's, the host
partitioner against the JAX package's, and the bare PPI-style step."""

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
CASES = [c[0] for c in check.GP_LAYER_CASES]
# tests/test_graph_parallel.py's layer bar.
LAYER_TOL = dict(rtol=3e-4, atol=2e-4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the four ranks saw (rank r's file)."""
    out = tmp_path_factory.mktemp("gp_layers")
    line = check.run_multihost_check(RANKS, out_dir=str(out),
                                     kind="gp_layers")
    assert "MULTIHOST_OK processes=4" in line and "kind=gp_layers" in line
    return [torch.load(str(out / ("rank%d.pt" % r)), weights_only=False)
            for r in range(RANKS)]


@pytest.mark.parametrize("case", CASES)
def test_gp_layer_matches_jax_and_the_single_process_layer(case, ranks):
    """The 4-rank layer's gathered output against the JAX package's
    GP_LAYERS on 4 virtual devices (same graph, same weights) and against
    the port's single-process layer on the whole graph (the f32 plain
    branches), within rtol 3e-4 / atol 2e-4; its gradients (of
    sum(output * R), summed over the ranks) for the parameters and the
    input states against the single-process layer's."""
    rec = ranks[0]["layers"][case]
    ci = CASES.index(case)
    _, layer, init_kw, apply_kw = check.GP_LAYER_CASES[ci]
    feats, adj = check.random_typed_graph(check.GP_LAYER_NODES, seed=ci)
    n, d = feats.shape
    template = J_LAYERS[layer][0](jax.random.PRNGKey(0), len(adj), d,
                                 **init_kw)
    params = unflatten_like(template, rec["params"])
    shards, _, n_global = j_gp.partition_graph(feats, adj, RANKS)
    gp_layer = j_gp.GP_LAYERS[layer]

    def fwd(shard):
        shard = jax.tree_util.tree_map(lambda x: x[0], shard)
        return gp_layer(params, shard, shard.node_features + 0.0, "gp",
                        **apply_kw)[None]

    sharded = shard_map(fwd, mesh=make_mesh(RANKS, axis_name="gp"),
                        in_specs=(P("gp"),), out_specs=P("gp"),
                        check_vma=False)
    want = np.asarray(jax.jit(sharded)(jax.tree_util.tree_map(
        jnp.asarray, shards))).reshape(n_global, d)[:n]
    got = rec["split"]
    np.testing.assert_allclose(got["out"], want, **LAYER_TOL)
    np.testing.assert_allclose(got["out"], rec["single"]["out"], **LAYER_TOL)
    np.testing.assert_allclose(rec["single"]["out"], want, **LAYER_TOL)
    for g, s in zip(got["grads"], rec["single"]["grads"]):
        np.testing.assert_allclose(g, s, **LAYER_TOL)
    np.testing.assert_allclose(got["grad_h"], rec["single"]["grad_h"],
                               **LAYER_TOL)
    assert max(float(np.abs(g).max()) for g in got["grads"]) > 0


@pytest.mark.parametrize("case", CASES)
def test_split_matches_merged_and_reads_no_gathered_rows_early(case, ranks):
    """The source-ownership split (local-source edges from the rank's own
    table, before the wait) against the merged stream, within 1e-5
    (other sum orders); and the split run again with every all-gather's
    output NaN until its wait(): the same output and gradients bit for
    bit, so the local half has no data path from the collective."""
    rec = ranks[0]["layers"][case]
    split, merged, held = rec["split"], rec["merged"], rec["held"]
    np.testing.assert_allclose(split["out"], merged["out"], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(split["grads"], merged["grads"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert np.isfinite(held["out"]).all()
    assert np.array_equal(held["out"], split["out"])
    assert np.array_equal(held["grad_h"], split["grad_h"])
    assert all(np.array_equal(a, b) for a, b in zip(held["grads"],
                                                     split["grads"]))


@pytest.mark.parametrize("n,parts", [(90, 4), (96, 4), (90, 2), (200, 3)])
def test_partition_graph_matches_jax(n, parts):
    """The port's host partitioner against the JAX package's: every field
    of every partition's merged, local and remote streams equal, the
    partitions' sizes and the shared edge pad; the last partition short
    where n is not a multiple of the partition size."""
    feats, adj = check.random_typed_graph(n, seed=n + parts)
    got, nl, ng = gp.partition_graph(feats, adj, parts)
    want, wnl, wng = j_gp.partition_graph(feats, adj, parts)
    assert (nl, ng) == (wnl, wng)
    assert len(got) == parts
    for p, shard in enumerate(got):
        for name in ("node_features", "node_mask"):
            assert np.array_equal(getattr(shard, name),
                                  np.asarray(getattr(want, name))[p]), name
        for stream in ("flat", "flat_local", "flat_remote"):
            for field in gp.GPFlatEdges._fields:
                assert np.array_equal(
                    getattr(getattr(shard, stream), field),
                    np.asarray(getattr(getattr(want, stream), field))[p]), (
                        p, stream, field)
    assert got[-1].node_mask.sum() == n - (parts - 1) * nl
    # A partition built alone is the same piece.
    (alone,), _, _ = gp.partition_graph(feats, adj, parts, parts=[1])
    assert np.array_equal(alone.flat.src_flat, got[1].flat.src_flat)


def test_partition_task_batch_matches_jax():
    """partition_task_batch on a QM9 batch (the port's and the JAX
    package's batches of the same molecules are field for field equal)
    at the fold-static edge pad, against the JAX package's."""
    from tf_gnn_samples_tpu.ops.graph import bucket_size as j_bucket
    from tf_gnn_samples_tpu.tasks import base as j_base
    from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
    from tf_gnn_samples_torch.tasks import base as t_base
    from tf_gnn_samples_torch.tasks import qm9 as t_qm9

    batch = check.step_batches(check.qm9_task(t_qm9, t_base), t_base, 1)[0]
    jbatch = check.step_batches(check.qm9_task(j_qm9, j_base), j_base, 1)[0]
    budget = gp.batch_edge_budget(batch)
    assert budget == j_bucket(sum(e.senders.shape[0]
                                  for e in jbatch.graph.edges), min_size=64)
    got, nl, ng = gp.partition_task_batch(batch, 2, batch.graph.n_pad,
                                          budget)
    want, wnl, wng = j_gp.partition_task_batch(jbatch, 2, jbatch.graph.n_pad,
                                               budget)
    assert (nl, ng) == (wnl, wng)
    for p in range(2):
        for stream in ("flat", "flat_local", "flat_remote"):
            for field in gp.GPFlatEdges._fields:
                assert np.array_equal(
                    getattr(getattr(got[p], stream), field),
                    np.asarray(getattr(getattr(want, stream), field))[p]), (
                        p, stream, field)
        assert np.array_equal(got[p].node_features,
                              np.asarray(want.node_features)[p])
    assert got[0].flat.src_flat.shape[0] == budget


def test_bare_train_step_decreases_the_loss(ranks):
    """make_gp_train_step (rgcn, PPI-style sigmoid head, Adam): five steps
    on 4 ranks lower the mean loss, the same on every rank."""
    losses = ranks[0]["bare_losses"]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert all(r["bare_losses"] == losses for r in ranks)
