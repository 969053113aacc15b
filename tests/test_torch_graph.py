"""Host batches of the port against the JAX package's: every field the
port's pad_graph_batch / QM9 make_minibatch_iterator emits must EQUAL the
JAX array (np.array_equal), on QM9 samples and on random multi-type
graphs, and the batch specs and greedy packs must be the same. The rank
windows are plain ints in the port and must equal what token_window
decodes from the JAX package's shape tokens; the diluted src stream
(sd_rank, sd_fine, sd_coarse) must equal the JAX arrays where it engages
(a graph of PPI-like degree) and where it does not (QM9)."""

import numpy as np
import pytest

from tf_gnn_samples_tpu.ops import edge_ops as j_edge_ops
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
        got = getattr(tb.flat, field)
        if field.startswith("win_"):
            assert type(got) is int, field
            assert got == j_graph.token_window(getattr(jb.flat, field)), field
            continue
        if field == "tm_self":  # shape tokens in JAX, plain bools here
            assert got == j_edge_ops.tm_self_types(jb), field
            assert all(type(s) is bool for s in got), field
            continue
        if field == "tm_offs":  # the JAX layer's cumsum of its edge blocks
            offs = np.cumsum([0] + [e.senders.shape[0] for e in jb.edges])
            assert got == tuple(int(o) for o in offs), field
            assert all(type(o) is int for o in got), field
            continue
        got = got.numpy()
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


def ppi_like_graph(seed, num_nodes=600, degree=14):
    """A numpy-made graph of PPI-like degree: `degree` random in-edges per
    node on average, their reverses as a second type, and a self-loop
    type."""
    rng = np.random.RandomState(seed)
    fwd = rng.randint(0, num_nodes, size=(num_nodes * degree, 2)).astype(
        np.int32)
    loops = np.stack([np.arange(num_nodes)] * 2, 1).astype(np.int32)
    feats = rng.randn(num_nodes, 8).astype(np.float32)
    gids = np.sort(rng.randint(0, 2, size=num_nodes)).astype(np.int32)
    return feats, [fwd, fwd[:, ::-1].copy(), loops], gids


@pytest.mark.parametrize("seed,degree", [(0, 14), (1, 28), (2, 6)])
def test_ppi_like_graph_dilutes_as_jax(seed, degree):
    """At PPI-like degree the fine window engages, so the diluted stream is
    built: cap ceil(1.03 * E / 2048) * 2048, fill slots with SD_FILL that
    repeat the previous rank, every 256-slot block's aligned span within
    win_sd; all equal to the JAX arrays (assert_graphs_equal)."""
    feats, adj, gids = ppi_like_graph(seed, degree=degree)
    e_pads = [-(-a.shape[0] // 2048) * 2048 for a in adj]
    jb = j_graph.pad_graph_batch(feats, adj, gids, 2, e_pads=e_pads)
    tb = t_graph.pad_graph_batch(feats, adj, gids, 2, e_pads=e_pads)
    assert_graphs_equal(tb, jb)
    flat = tb.flat
    e_tot = flat.src_flat.shape[0]
    assert flat.win_fine in (16, 32, 64, 128)
    assert flat.win_sd in (32, 64, 128)  # dilution engaged
    cap = flat.sd_rank.shape[0]
    assert cap == -(-103 * e_tot // (100 * 2048)) * 2048
    sd_rank, sd_fine = flat.sd_rank.numpy(), flat.sd_fine.numpy()
    fill = sd_fine == t_graph.SD_FILL
    assert fill.any() and (flat.sd_coarse.numpy()[fill] == t_graph.SD_FILL).all()
    assert (np.diff(sd_rank) >= 0).all() and (np.diff(sd_rank) <= 1).all()
    assert (sd_rank[1:][fill[1:]] == sd_rank[:-1][fill[1:]]).all()
    blocks = sd_rank.reshape(-1, 256)
    assert (blocks[:, -1] - (blocks[:, 0] & ~7) + 1 <= flat.win_sd).all()
    # The real slots are the real edges of the undiluted stream, in order.
    n_real = int(flat.mask.sum())
    assert np.array_equal(sd_rank[~fill], flat.src_sorted_rank.numpy()[:n_real])
    assert np.array_equal(sd_fine[~fill],
                          flat.fine_rank_by_src.numpy()[:n_real])


def test_qm9_tuned_batch_is_undiluted(qm9_tasks):
    """At QM9's degrees (about 3 edges per receiver) the fine window is 0 in
    both packages, so the cap rule gives an empty sd stream and every
    src-order consumer reads the undiluted one: the tuned QM9 paths never
    dilute. Checked on packs of 2,500 nodes here (the arrays equal the JAX
    package's, test_qm9_batches_equal_jax)."""
    (jt, jdata), (tt, tdata) = qm9_tasks
    jbs = jt.make_minibatch_iterator(jdata, j_base.DataFold.VALIDATION, 2500)
    tbs = tt.make_minibatch_iterator(tdata, t_base.DataFold.VALIDATION, 2500)
    for tb, jb in zip(tbs, jbs):
        flat = tb.graph.flat
        assert flat.win_fine == 0 == j_graph.token_window(jb.graph.flat.win_fine)
        assert flat.win_sd == 0 and flat.sd_rank.shape == (0,)
        assert jb.graph.flat.sd_rank.shape == (0,)
        assert flat.sd_fine.shape == flat.sd_coarse.shape == (0,)


@pytest.mark.parametrize("cap_blocks", [0, 1, 30, 40, 48, 400])
def test_dilute_src_stream_equals_jax(cap_blocks):
    """_dilute_src_stream against the JAX function on a stream with a
    low-degree head (one edge per rank: 256 ranks per block undiluted) and
    a dense tail, for caps that fit no window (None on both sides), only a
    wide one, and the narrowest."""
    rng = np.random.RandomState(5)
    ranks = np.concatenate([np.arange(900),
                            900 + np.sort(rng.randint(0, 300, size=7000))])
    ranks = np.unique(ranks, return_inverse=True)[1].astype(np.int32)
    comp = [rng.randint(0, 1000, size=ranks.shape[0]).astype(np.int32),
            rng.randint(0, 1000, size=ranks.shape[0]).astype(np.int32)]
    want = j_graph._dilute_src_stream(ranks, comp, cap_blocks * 256)
    got = t_graph._dilute_src_stream(ranks, comp, cap_blocks * 256)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[2] == want[2]
        assert np.array_equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert np.array_equal(a, b)
    assert t_graph.SD_FILL == j_graph.SD_FILL
    for a, b in [(0, 32), (32, 0), (16, 64), (128, 32), (0, 0)]:
        assert t_graph._merge_windows(a, b) == j_graph._merge_windows(a, b)


def test_rank_window_equals_jax():
    rng = np.random.RandomState(9)
    for e, groups in [(0, 1), (1, 1), (255, 40), (256, 256), (257, 9),
                      (5000, 300), (5000, 2500), (4096, 4096), (3000, 1400)]:
        ranks = np.sort(rng.randint(0, groups, size=e))
        ranks = (np.unique(ranks, return_inverse=True)[1].astype(np.int32)
                 if e else ranks.astype(np.int32))
        assert t_graph.rank_window(ranks) == j_graph.rank_window(ranks), e


def self_loop_graph(seed=7, n=300, edges=1900):
    """A dense random type and a pure self-loop type in which node 0 has a
    DOUBLE self loop, each padded to one 2048-edge row (the fixture of the
    JAX package's own type-major Edge-MLP1 test)."""
    rng = np.random.RandomState(seed)
    nodes = np.arange(n, dtype=np.int32)
    self_adj = np.stack([nodes, nodes], axis=1)
    self_adj = np.concatenate([self_adj, self_adj[:1]], axis=0)
    dense_adj = np.stack([rng.randint(0, n, size=edges),
                          rng.randint(0, n, size=edges)], 1).astype(np.int32)
    feats = rng.randn(n, 8).astype(np.float32)
    return feats, [dense_adj, self_adj], np.zeros(n, np.int32)


def check_type_major_view(tb):
    """What the consumers of the type-major view rely on."""
    flat = tb.flat
    n_pad, L = tb.n_pad, tb.num_edge_types
    tm_rank = flat.tm_rank.numpy()
    e = tm_rank.shape[0]
    assert flat.tm_offs[0] == 0 and flat.tm_offs[-1] == e
    assert len(flat.tm_offs) == L + 1 == len(flat.tm_self) + 1
    steps = np.diff(tm_rank)
    assert tm_rank[0] == 0 and ((steps == 0) | (steps == 1)).all()
    # Same edges as the receiver-sorted stream, type by type.
    src_tm = flat.tm_src_flat.numpy()
    assert np.array_equal(np.sort(src_tm), np.sort(flat.src_flat.numpy()))
    real = src_tm < L * n_pad
    types = np.repeat(np.arange(L), np.diff(flat.tm_offs))
    assert np.array_equal(src_tm[real] // n_pad, types[real])
    # The src-sorted values are shared with the receiver-major view.
    perm = flat.tm_perm_by_src.numpy()
    assert np.array_equal(src_tm[perm],
                          flat.src_flat.numpy()[flat.perm_by_src.numpy()])
    assert np.array_equal(flat.tm_rank_by_src.numpy(), tm_rank[perm])
    # Rank rows: a real edge of a streamed type maps to its (type,
    # receiver) slot and back; self-loop types and padding map to the
    # dump receiver and have no slot.
    to_flat, to_rcv = flat.tm_to_flat.numpy(), flat.tm_to_rcv.numpy()
    from_flat = flat.tm_from_flat.numpy()
    is_self = np.asarray(flat.tm_self)[types]
    streamed = real & ~is_self
    slots = to_flat[tm_rank[streamed]]
    assert np.array_equal(slots // n_pad, types[streamed])
    assert np.array_equal(to_rcv[tm_rank[streamed]], slots % n_pad)
    assert np.array_equal(from_flat[slots], tm_rank[streamed])
    assert (to_rcv[tm_rank[~streamed]] == n_pad).all()
    assert (from_flat >= 0).sum() == np.unique(slots).shape[0]
    for l in range(L):
        if flat.tm_self[l]:
            assert (from_flat[l * n_pad:(l + 1) * n_pad] == -1).all()


def test_type_major_view_with_self_loop_type_equals_jax():
    """The type-major view on the dense two-type graph with a pure
    self-loop type and one doubled self edge: every array equals the JAX
    package's (assert_graphs_equal), the self-loop type is flagged, and the
    window (measured over the blocks of the other type only) is one the
    JAX package's type-major gate accepts."""
    feats, adj, gids = self_loop_graph()
    kwargs = dict(n_pad=512, e_pads=[2048, 2048], g_pad=16)
    jb = j_graph.pad_graph_batch(feats, adj, gids, 1, **kwargs)
    tb = t_graph.pad_graph_batch(feats, adj, gids, 1, **kwargs)
    assert_graphs_equal(tb, jb)
    assert tb.flat.tm_self == (False, True)
    assert tb.flat.tm_offs == (0, 2048, 4096)
    assert 0 < tb.flat.win_tm <= 64
    assert float(tb.typed_incoming_counts[1, 0]) == 2.0  # the double loop
    check_type_major_view(tb)


@pytest.mark.parametrize("seed,degree", [(0, 14), (3, 4)])
def test_type_major_view_on_ppi_like_graph_equals_jax(seed, degree):
    feats, adj, gids = ppi_like_graph(seed, degree=degree)
    e_pads = [-(-a.shape[0] // 2048) * 2048 for a in adj]
    jb = j_graph.pad_graph_batch(feats, adj, gids, 2, e_pads=e_pads)
    tb = t_graph.pad_graph_batch(feats, adj, gids, 2, e_pads=e_pads)
    assert_graphs_equal(tb, jb)
    assert tb.flat.tm_self == (False, False, True)
    check_type_major_view(tb)


def test_type_major_view_on_qm9_equals_jax(qm9_tasks):
    """QM9's type 0 is the self-loop type (add_self_loop_edges); the other
    four stream. The arrays equal the JAX package's."""
    (jt, jdata), (tt, tdata) = qm9_tasks
    jb = next(jt.make_minibatch_iterator(jdata, j_base.DataFold.VALIDATION,
                                         2500))
    tb = next(tt.make_minibatch_iterator(tdata, t_base.DataFold.VALIDATION,
                                         2500))
    assert_graphs_equal(tb.graph, jb.graph)
    assert tb.graph.flat.tm_self == (True, False, False, False, False)
    assert tb.graph.flat.win_tm == j_graph.token_window(jb.graph.flat.win_tm)
    check_type_major_view(tb.graph)


@pytest.mark.parametrize("e,groups,relevant_from", [
    (0, 1, 0), (1, 1, 0), (255, 40, 0), (257, 9, 256), (5000, 300, 2048),
    (5000, 2500, 4000), (4096, 4096, 4096), (3000, 1400, 0)])
def test_rank_window_masked_equals_jax(e, groups, relevant_from):
    """_rank_window_masked against the JAX function: blocks without a
    relevant edge do not count, so a stream whose wide-span blocks are all
    irrelevant keeps a narrow window."""
    rng = np.random.RandomState(e + groups)
    ranks = np.sort(rng.randint(0, groups, size=e))
    ranks = (np.unique(ranks, return_inverse=True)[1].astype(np.int32)
             if e else ranks.astype(np.int32))
    for relevant in (np.arange(e) >= relevant_from,
                     np.arange(e) < relevant_from,
                     rng.rand(e) < 0.01):
        assert (t_graph._rank_window_masked(ranks, relevant)
                == j_graph._rank_window_masked(ranks, relevant))
