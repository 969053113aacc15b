"""chip_smoke.py's halo phase (`halo_phase`: graph_parallel 2 with
graph_parallel_halo, two spawned ranks over gloo) and hybrid phase
(`hybrid_phase`: dp 2 x gp 2, four spawned ranks) on the CPU at a tiny
width: each passes as it is, and each of its checks rejects a fault
planted in a rank. Halo: halo_pad and the send lists from the rank's own
boundary alone, the all-to-all's chunks taken in the wrong order, a
remote edge moved onto a padded halo slot. Hybrid: the gp gradients
summed and not averaged, the dp sum unweighted by the rows' graphs, the
heads' dropout masks drawn per rank."""

import functools
import gzip
import itertools
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"graph_num_layers": 1, "hidden_size": 16, "max_nodes_in_batch": 600}
# 700-node batches: the first two hold 39 and 38 graphs, so weighting the
# rows by their graphs differs from an unweighted mean.
TINY_HYBRID = dict(TINY, max_nodes_in_batch=700)


@pytest.fixture(scope="module")
def qm9_dir(tmp_path_factory):
    """A data directory with the first 120 train and 40 valid graphs."""
    d = tmp_path_factory.mktemp("qm9_halo_phase")
    for fold, count in (("train", 120), ("valid", 40)):
        with gzip.open(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                       "rt") as fin, \
                gzip.open(str(d / (fold + ".jsonl.gz")), "wt") as fout:
            fout.writelines(itertools.islice(fin, count))
    return str(d)


def planted_halo_rank(rank, cfg, fault):
    """chip_smoke.gp_rank with cfg["halo"] on the CPU with `fault`
    planted."""
    import chip_smoke
    from tf_gnn_samples_torch.parallel import _multihost_check as check
    from tf_gnn_samples_torch.parallel import graph_parallel as gp

    torch.set_num_threads(1)  # the ranks share the test's cores
    if fault == "own_boundary":
        real_needs = gp._halo_needs

        def own_needs(per_part, n_local, num_partitions):
            need = real_needs(per_part, n_local, num_partitions)
            empty = np.zeros(0, np.int64)
            return [row if q == rank else [empty] * num_partitions
                    for q, row in enumerate(need)]

        gp._halo_needs = own_needs
    if fault == "chunks_reversed":
        def wait(self):
            self.work.wait()
            chunks = self._recv.view(self.group_size(), -1,
                                     self._recv.shape[-1])
            return chunks.flip(0).reshape(self._recv.shape)

        gp.PendingHalo.group_size = lambda self: gp.world(self.group)[1]
        gp.PendingHalo.wait = wait
    if fault == "padded_slot_edge":
        real_partition = gp.partition_task_batch_halo

        def planted(*args, **kwargs):
            shards, *rest = real_partition(*args, **kwargs)
            moved = [check.plant_padded_slot_edge(s) for s in shards]
            assert all(m is not None for m in moved), "no edge to plant"
            return (moved, *rest)

        gp.partition_task_batch_halo = planted
    chip_smoke.gp_rank(rank, cfg)


def planted_hybrid_rank(rank, cfg, fault):
    """chip_smoke.hybrid_rank on the CPU with `fault` planted."""
    import chip_smoke
    from tf_gnn_samples_torch.parallel import graph_parallel as gp
    from tf_gnn_samples_torch.parallel import multihost

    torch.set_num_threads(1)
    if fault == "gp_not_averaged":
        real_reduce = gp._reduce_grads
        gp._reduce_grads = lambda grads, group=None, mean=True: real_reduce(
            grads, group, False)
    if fault == "dp_unweighted":
        multihost._dp_weight = lambda num_graphs, total: (
            torch.ones_like(total) / chip_smoke.HYBRID_DP)
    if fault == "head_rank_dropout":
        real_seed = multihost.seed_hybrid_dropout

        def seed(model, s, groups):
            real_seed(model, s, groups)
            model._dropout_gen.manual_seed(s + rank)

        multihost.seed_hybrid_dropout = seed
    chip_smoke.hybrid_rank(rank, cfg)


@pytest.mark.parametrize("fault", ["none", "own_boundary", "chunks_reversed",
                                   "padded_slot_edge"])
def test_halo_phase_checks_reject_planted_faults(qm9_dir, tmp_path, fault):
    """halo_phase on the CPU (two spawned ranks over gloo; one layer, 16
    columns, 600-node batches): it passes as it is, one all-to-all a layer
    each way and one all-gather of the final states, no hand-kernel
    launch; it fails where each rank measures halo_pad and builds its send
    lists from its own boundary alone (it sends row 0 where its peer needs
    boundary rows), where the receive buffer's chunks are taken in reverse
    rank order, and where a remote edge reads a padded halo slot."""
    from chip_smoke import halo_phase

    kwargs = dict(data=qm9_dir, out=str(tmp_path), device="cpu",
                  overrides=TINY, timed=False,
                  worker=functools.partial(planted_halo_rank, fault=fault))
    if fault == "none":
        r0 = halo_phase(**kwargs)
        t = r0["traffic"]
        assert t["all_to_all_calls"] == t["all_to_all_bwd_calls"] == 1
        assert t["all_to_all_bytes"] == 2 * r0["halo_pad"] * 16 * 4
        assert t["all_gather_calls"] == t["reduce_scatter_calls"] == 1
        assert [e["name"] for e in r0["epochs"]] == ["packing", "cached"]
        assert r0["halo_pad"] < r0["n_local"]
        return
    match = {"own_boundary": "gp eval loss",
             "chunks_reversed": "gp eval loss",
             "padded_slot_edge": "gp eval loss"}[fault]
    with pytest.raises(Exception, match=match):
        halo_phase(**kwargs)


@pytest.mark.parametrize("fault", ["none", "gp_not_averaged", "dp_unweighted",
                                   "head_rank_dropout"])
def test_hybrid_phase_checks_reject_planted_faults(qm9_dir, tmp_path, fault):
    """hybrid_phase on the CPU (four spawned ranks over gloo, dp 2 x gp 2;
    one layer, 16 columns, 700-node batches of 39 and 38 graphs): it passes
    as it is, the all-gather step by all-gathers and the halo step by
    all-to-alls, no hand-kernel launch, total_graphs the two batches'; it
    fails on gp gradients summed and not averaged and on a dp sum
    unweighted by graphs (off the union step), and on the heads' dropout
    masks drawn per rank (the heads' generator differs within a row)."""
    from chip_smoke import hybrid_phase

    kwargs = dict(data=qm9_dir, out=str(tmp_path), device="cpu",
                  overrides=TINY_HYBRID, timed=False,
                  worker=functools.partial(planted_hybrid_rank, fault=fault))
    if fault == "none":
        r0 = hybrid_phase(**kwargs)
        assert r0["graphs"][0] != r0["graphs"][1]
        ag, halo = r0["strategies"]["allgather"], r0["strategies"]["halo"]
        assert ag["traffic"]["all_gather_calls"] == 2  # a layer, the states
        assert ag["traffic"]["all_to_all_calls"] == 0
        assert halo["traffic"]["all_to_all_calls"] == 1
        assert halo["traffic"]["all_gather_calls"] == 1
        return
    match = {"gp_not_averaged": "differ from the eager run's",
             "dp_unweighted": "differ from the eager run's",
             "head_rank_dropout": "dropout generator is not alike"}[fault]
    with pytest.raises(Exception, match=match):
        hybrid_phase(**kwargs)
