"""chip_smoke.py's gp phase (`gp_phase`: graph_parallel 2 as two spawned
ranks over gloo) on the CPU at a tiny width: it passes as it is, and each
of its checks rejects a fault planted in a rank: a rank given another
batch than its peer, the all-gather's layout left unpermuted (the ranks'
[P, L, Nl, D] pieces read as [L, P * Nl, D]), the replicated head's
dropout masks drawn per rank, and the gradients summed over the ranks
but not averaged. Where the tuned optimizer (RMSProp, clipped per tensor)
all but ignores a gradient's scale, the gradient check sees it."""

import functools
import gzip
import itertools
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"graph_num_layers": 1, "hidden_size": 16, "max_nodes_in_batch": 600}


@pytest.fixture(scope="module")
def qm9_dir(tmp_path_factory):
    """A data directory with the first 120 train and 40 valid graphs."""
    d = tmp_path_factory.mktemp("qm9_gp_phase")
    for fold, count in (("train", 120), ("valid", 40)):
        with gzip.open(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                       "rt") as fin, \
                gzip.open(str(d / (fold + ".jsonl.gz")), "wt") as fout:
            fout.writelines(itertools.islice(fin, count))
    return str(d)


def planted_gp_rank(rank, cfg, fault):
    """chip_smoke.gp_rank on the CPU with `fault` planted."""
    import chip_smoke
    from tf_gnn_samples_torch.parallel import graph_parallel as gp
    from tf_gnn_samples_torch.runtime.model import SparseGraphModel

    torch.set_num_threads(1)  # two ranks share the test's cores
    if fault == "layout_permuted":
        def wait(self):
            self.work.wait()
            shape = list(self.shape)
            shape[self.dim] *= self._stacked.shape[0] // self.shape[0]
            return self._stacked.reshape(shape)

        gp.PendingGather.wait = wait
    if fault == "head_rank_dropout":
        real = SparseGraphModel._seed_gp_dropout

        def seed(self, s):
            real(self, s)
            self._dropout_gen.manual_seed(s + rank)

        SparseGraphModel._seed_gp_dropout = seed
    if fault == "not_averaged":
        real_reduce = gp._reduce_grads
        gp._reduce_grads = lambda grads, group=None, mean=True: real_reduce(
            grads, group, False)
    chip_smoke.gp_rank(rank, cfg)


@pytest.mark.parametrize("fault", ["none", "other_rank_batch",
                                   "layout_permuted", "head_rank_dropout",
                                   "not_averaged"])
def test_gp_phase_checks_reject_planted_faults(qm9_dir, tmp_path, fault):
    """gp_phase on the CPU (two spawned ranks over gloo; one layer, 16
    columns, 600-node batches): it passes as it is, with no hand-kernel
    launch, and fails on rank 1 stepping the second batch (the batch keys
    differ), on the unpermuted gather (the eval loss off the single
    process's), on per-rank head dropout (the replicated models'
    generator in another state on each rank: QM9's head has no hidden
    layer, so no mask of its shows it in the loss) and
    on unaveraged gradients (off the single process's)."""
    from chip_smoke import gp_phase

    kwargs = dict(data=qm9_dir, out=str(tmp_path), device="cpu",
                  overrides=TINY, timed=False,
                  worker=functools.partial(planted_gp_rank, fault=fault))
    if fault == "other_rank_batch":
        kwargs["batch_of_rank"] = {1: 1}
    if fault == "none":
        r0 = gp_phase(**kwargs)
        assert r0["traffic"]["all_gather_calls"] == 2  # a layer, the states
        assert r0["traffic"]["reduce_scatter_calls"] == 2
        assert [e["name"] for e in r0["epochs"]] == ["packing", "cached"]
        assert r0["n_local"] * 2 >= r0["n_pad"]
        return
    match = {"other_rank_batch": "out of step",
             "layout_permuted": "gp eval loss",
             "head_rank_dropout": "dropout generator differs across the "
                                  "ranks",
             "not_averaged": "gp gradients against"}[fault]
    with pytest.raises(Exception, match=match):
        gp_phase(**kwargs)
