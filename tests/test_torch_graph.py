"""Host batches of the port against the JAX package's: every field the
port's pad_graph_batch / QM9 make_minibatch_iterator emits must EQUAL the
JAX array (np.array_equal), on QM9 samples and on random multi-type
graphs, and the batch specs and greedy packs must be the same."""

import numpy as np
import pytest

from tf_gnn_samples_tpu.ops import graph as j_graph
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

from helpers import random_typed_graph

QM9_VALID = "data/qm9/valid.jsonl.gz"


def assert_graphs_equal(tb, jb):
    """Every field of the port's GraphBatch equals the JAX batch's."""
    for field in tb.flat._fields:
        got = getattr(tb.flat, field).numpy()
        want = np.asarray(getattr(jb.flat, field))
        assert got.shape == want.shape and np.array_equal(got, want), field
    for field in tb._fields:
        if field in ("flat", "num_graphs"):
            continue
        if getattr(tb, field) is None:  # attached by the runtime (dense_adj)
            assert getattr(jb, field) is None, field
            continue
        got = getattr(tb, field).numpy()
        want = np.asarray(getattr(jb, field))
        assert got.shape == want.shape and np.array_equal(got, want), field
    assert tb.num_graphs == int(jb.num_graphs)
    assert tb.n_pad == jb.n_pad and tb.g_pad == jb.g_pad
    assert tb.num_edge_types == jb.num_edge_types


@pytest.fixture(scope="module")
def qm9_tasks():
    """Both packages' QM9 tasks on the first 400 validation graphs."""
    tasks = []
    for mod in (j_qm9, t_qm9):
        task = mod.QM9_Task(mod.QM9_Task.default_params())
        data = task._QM9_Task__load_data(QM9_VALID)[:400]
        tasks.append((task, data))
    return tasks


@pytest.mark.parametrize("max_nodes,fold", [(600, "VALIDATION"),
                                            (2500, "VALIDATION"),
                                            (2500, "TRAIN")])
def test_qm9_batches_equal_jax(qm9_tasks, max_nodes, fold):
    (jt, jdata), (tt, tdata) = qm9_tasks
    # TRAIN shuffles with the global numpy RNG in both packages.
    np.random.seed(3)
    jbatches = list(jt.make_minibatch_iterator(
        jdata, j_base.DataFold[fold], max_nodes))
    np.random.seed(3)
    tbatches = list(tt.make_minibatch_iterator(
        tdata, t_base.DataFold[fold], max_nodes))
    assert len(tbatches) == len(jbatches) > 1
    for tb, jb in zip(tbatches, jbatches):
        assert_graphs_equal(tb.graph, jb.graph)
        assert np.array_equal(tb.aux["target_values"].numpy(),
                              jb.aux["target_values"])
        assert (tb.num_graphs, tb.num_nodes, tb.num_edges) == (
            jb.num_graphs, jb.num_nodes, jb.num_edges)


@pytest.mark.parametrize("explicit_pads", [False, True])
def test_random_multitype_graphs_equal_jax(explicit_pads):
    rng = np.random.default_rng(11)
    for trial in range(4):
        feats, adj = random_typed_graph(rng, num_nodes=40 + 7 * trial,
                                        num_edge_types=3 + trial % 2,
                                        avg_degree=5)
        n = feats.shape[0]
        # A self-loop type, as QM9's type 0, and an empty type.
        adj = [np.stack([np.arange(n)] * 2, 1).astype(np.int32)] + adj
        adj.append(np.zeros((0, 2), np.int32))
        gids = np.sort(rng.integers(0, 3, size=n)).astype(np.int32)
        kwargs = {}
        if explicit_pads:
            kwargs = dict(n_pad=n + 9, e_pads=[a.shape[0] + 5 for a in adj],
                          g_pad=4)
        jb = j_graph.pad_graph_batch(feats, adj, gids, 3, **kwargs)
        tb = t_graph.pad_graph_batch(feats, adj, gids, 3, **kwargs)
        assert_graphs_equal(tb, jb)


def test_batch_specs_and_packs_equal_jax(qm9_tasks):
    (jt, jdata), (tt, tdata) = qm9_tasks
    sizes = jt._graph_sizes(jdata)
    assert sizes == tt._graph_sizes(tdata)
    for max_nodes in (600, 3000):
        jspecs = j_base.compute_batch_specs(sizes, max_nodes, jt.num_edge_types)
        tspecs = t_base.compute_batch_specs(sizes, max_nodes, tt.num_edge_types)
        assert [tuple(s) for s in tspecs] == [tuple(s) for s in jspecs]
        assert tuple(t_base.compute_batch_spec(
            sizes, max_nodes, tt.num_edge_types)) == tuple(
            j_base.compute_batch_spec(sizes, max_nodes, jt.num_edge_types))
        order = np.random.RandomState(max_nodes).permutation(len(sizes))
        jpacks = list(j_base.pack_greedy(sizes, order, jspecs[-1], max_nodes))
        tpacks = list(t_base.pack_greedy(sizes, order, tspecs[-1], max_nodes))
        assert tpacks == jpacks
        for pack in tpacks:
            n = sum(sizes[i][0] for i in pack)
            e = np.sum([sizes[i][1] for i in pack], axis=0)
            assert tuple(t_base.select_spec(tspecs, n, e, len(pack))) == tuple(
                j_base.select_spec(jspecs, n, e, len(pack)))
    for n in (1, 127, 128, 129, 1000, 5000, 50001):
        assert t_graph.bucket_size(n) == j_graph.bucket_size(n)
