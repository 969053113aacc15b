"""`chip_smoke.py`'s dp phase (`dp_phase`: num_model_replicas 2 as two
spawned ranks over gloo) on the CPU at a tiny width with the card's
launches emulated: it passes as it is, and rejects a gradient left
unweighted by its graph count, a rank stepping the other rank's batch
and a scanned epoch that runs eager steps. (The kernels' checks:
tests/test_torch_chip_checks_kernels.py; the other phases':
tests/test_torch_chip_checks_phases.py; the gp phase's:
tests/test_torch_chip_checks_gp.py.)"""

import functools
import gzip
import itertools
import os

import pytest
import torch

from chip_smoke import expected_launches
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.runtime.model import SparseGraphModel


@pytest.fixture(scope="module")
def qm9_dir(tmp_path_factory):
    """A data directory with the first 120 train and 40 valid graphs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = tmp_path_factory.mktemp("qm9_cache_phase")
    for fold, count in (("train", 120), ("valid", 40)):
        with gzip.open(os.path.join(root, "data", "qm9", fold + ".jsonl.gz"),
                       "rt") as fin, \
                gzip.open(str(d / (fold + ".jsonl.gz")), "wt") as fout:
            fout.writelines(itertools.islice(fin, count))
    return str(d)


# ---- the dp phase ---------------------------------------------------------

def planted_dp_rank(rank, cfg, fault):
    """chip_smoke.dp_rank on the CPU with every step's launches emulated
    (expected_launches for one GNN-FiLM batch) and `fault` planted: a
    rank's gradient left unweighted by its graph count, rank 1 stepping
    rank 0's batch in the dp step, or a scanned epoch that runs eager
    steps."""
    import chip_smoke
    from tf_gnn_samples_torch.parallel import data_parallel as dp
    from tf_gnn_samples_torch.runtime import model as t_model

    torch.set_num_threads(1)  # two ranks share the test's cores

    def emulated(real):
        def step(self, batch, *args, **kwargs):
            layers = (self.params["graph_num_layers"]
                      * self.params["graph_num_timesteps_per_layer"])
            for k, n in expected_launches("GNN-FiLM", layers, 1, 1).items():
                rs.LAUNCHES[k] += n
            return real(self, batch, *args, **kwargs)
        return step

    SparseGraphModel._train_step_body = emulated(
        SparseGraphModel._train_step_body)
    real_local = dp.local_grads
    local = emulated(real_local)

    def local_grads(model, batch, gen, reduce_metrics=False, out=None):
        buf, metrics = local(model, batch, gen, reduce_metrics, out)
        if fault == "unweighted" and batch.num_graphs:
            buf[:-1] /= float(batch.num_graphs)
        return buf, metrics

    dp.local_grads = local_grads
    if fault == "other_rank_batch" and rank == 1:
        real_upload, seen = t_model.batch_to_device, []

        def upload(batch, device):
            seen.append(real_upload(batch, device))
            return seen[0] if len(seen) == 2 else seen[-1]

        t_model.batch_to_device = upload
    if fault == "eager_scanned":
        def eager(self, cached, data_fold):
            self.params["scan_epochs"] = False
            try:
                return self._run_epoch_on_stream(
                    "eager", self.task._loaded_data[data_fold], data_fold,
                    True)
            finally:
                self.params["scan_epochs"] = True

        SparseGraphModel._run_epoch_scanned = eager
    chip_smoke.dp_rank(rank, cfg)


@pytest.mark.parametrize("fault", ["none", "unweighted", "other_rank_batch",
                                   "eager_scanned"])
def test_dp_phase_checks_reject_planted_faults(qm9_dir, tmp_path, fault):
    """dp_phase on the CPU (two spawned ranks over gloo) at a tiny width
    (one layer, 16 columns, 600-node batches: 4 TRAIN batches in 2 replica
    groups), launches emulated: it passes as it is, and fails on a
    gradient left unweighted (the dp step off the union step), on rank 1
    stepping rank 0's batch (rank 0's union step off) and on a scanned
    epoch that runs eager steps."""
    from chip_smoke import dp_phase

    kwargs = dict(data=qm9_dir, out=str(tmp_path), device="cpu",
                  overrides={"graph_num_layers": 1, "hidden_size": 16,
                             "max_nodes_in_batch": 600}, timed=False,
                  worker=functools.partial(planted_dp_rank, fault=fault))
    if fault == "none":
        launches = dp_phase(**kwargs)
        # 4 epochs of 2 entries a rank, 2 ranks, 1 layer: K1 forward.
        assert launches["film_fwd"] == 4 * 2 * 2
        return
    match = {"unweighted": "dp step against the union step",
             "other_rank_batch": "rank 0 dp step against the union step",
             "eager_scanned": "ran eager steps"}[fault]
    with pytest.raises(Exception, match=match):
        dp_phase(**kwargs)
