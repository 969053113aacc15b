"""The checks of `chip_smoke.py`'s phases on the CPU at a tiny width,
with the card's launches emulated per batch. The cache, PPI, headline
and citation phases reject a cache that re-packs every epoch, a resume
that drops the slots, a step that launches one kernel more or another
branch's kernels, a metric line the bench regex cannot read, a loss that
is not finite and a headline run whose batches were not cached; the
VarMisuse phase also a streamed fold loaded in memory and a batch on a
branch without hand kernels, and its scan phase a scan that drops an
edge type and a "scan" that takes a kernel branch; the card-against-CPU
comparison rejects a loss or a gradient off; the replay, clamped-exp,
scanned-epochs and RGCN source-and-target checks their planted faults.
No kernel runs here. (The kernels' checks:
tests/test_torch_chip_checks_kernels.py; the dp phase's:
tests/test_torch_chip_checks_dp.py.)"""

import gzip
import itertools
import multiprocessing
import os

import numpy as np
import pytest
import torch

from chip_smoke import (CACHE_OVERRIDES, Path, batch_branch, cache_phase,
                        clamped_exp_check, fresh_masks_check,
                        replay_eager_check, replay_eager_redrawn,
                        replay_launch_check, EAGER_STEPS, REPLAY_DRAWS,
                        scanned_epochs_phase, REPLAY_CHECKED, ppi_headline,
                        reference_agrees, task_phase, ACCURACY, MICRO_F1,
                        PPI_PATHS, expected_launches)
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.runtime.model import SparseGraphModel

# ---- the cache phase ------------------------------------------------------

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


def emulate_launches(monkeypatch, extra_on_cached):
    """Count, for every step, the launches GNN-FiLM's kernels make on the
    card (`expected_launches` for one batch: the wrappers count nothing on
    CPU tensors) into a counter table of the test's own, so that no other
    test sees them; `extra_on_cached`: a step on a cached batch launches
    one K1 more."""
    monkeypatch.setattr(rs, "LAUNCHES", dict.fromkeys(rs.LAUNCHES, 0))
    real_train = SparseGraphModel._train_step
    real_eval = SparseGraphModel._eval_step

    def count(model, batch, n_bwd):
        layers = (model.params["graph_num_layers"]
                  * model.params["graph_num_timesteps_per_layer"])
        for k, n in expected_launches("GNN-FiLM", layers, 1, n_bwd).items():
            rs.LAUNCHES[k] += n
        if extra_on_cached and any(batch is b for fold in
                                   model._batch_cache.values() for b in fold):
            rs.LAUNCHES["film_fwd"] += 1

    def train_step(self, batch):
        count(self, batch, 1)
        return real_train(self, batch)

    def eval_step(self, batch):
        count(self, batch, 0)
        return real_eval(self, batch)

    monkeypatch.setattr(SparseGraphModel, "_train_step", train_step)
    monkeypatch.setattr(SparseGraphModel, "_eval_step", eval_step)


@pytest.mark.parametrize("fault", ["none", "repacks_every_epoch",
                                   "resume_drops_the_slots",
                                   "cache_changes_the_launches"])
def test_cache_phase_checks_reject_planted_faults(qm9_dir, tmp_path,
                                                  monkeypatch, fault):
    """cache_phase on the CPU at a tiny width (one layer, 16 columns,
    600-node batches) with the card's launches emulated: it passes as it
    is, and fails on a cache that re-packs every epoch, a resume that
    drops the optimizer's slots and a cache that changes the launches."""
    emulate_launches(monkeypatch, fault == "cache_changes_the_launches")
    overrides = {"graph_num_layers": 1, "hidden_size": 16,
                 "max_nodes_in_batch": 600}
    if fault == "repacks_every_epoch":
        overrides["repack_cached_every"] = 1
    if fault == "resume_drops_the_slots":
        real = SparseGraphModel.restore_training_state

        def restore(self, path):
            resumed = real(self, path)
            self.opt_state = self._optimizer.init(self._leaves())
            return resumed

        monkeypatch.setattr(SparseGraphModel, "restore_training_state",
                            restore)
    kwargs = dict(data=qm9_dir, out=str(tmp_path), device="cpu",
                  overrides=overrides, rates=False)
    assert CACHE_OVERRIDES["repack_cached_every"] == 2
    if fault == "none":
        launches = cache_phase(rs, **kwargs)
        # 4 train and 2 valid batches an epoch, 4 + 2 epochs, 1 layer
        assert launches["film_fwd"] == 6 * 6 and launches["film_bwd_dgb"] == 6 * 4
        return
    match = {"repacks_every_epoch": "TRAIN packs by epoch",
             "resume_drops_the_slots": "restored state differs",
             "cache_changes_the_launches": "launches"}[fault]
    with pytest.raises(AssertionError, match=match):
        cache_phase(rs, **kwargs)


def emulate_branch_launches(monkeypatch, fault="none"):
    """For every step, count the launches the card would make for the
    branch its batch takes (batch_branch, expected_launches) into a
    counter table of the test's own; `fault`: "extra_launch" counts one
    K5a more on each eval step, "other_branch" counts RGAT's streamed
    launches where its gate says fused."""
    from chip_smoke import expected_launches, streamed_types

    monkeypatch.setattr(rs, "LAUNCHES", dict.fromkeys(rs.LAUNCHES, 0))
    monkeypatch.setattr(rs, "FORM_LAUNCHES",
                        dict.fromkeys(rs.FORM_LAUNCHES, 0))
    real = {"train": SparseGraphModel._train_step,
            "eval": SparseGraphModel._eval_step}

    def count(model, batch, n_bwd):
        layers = (model.params["graph_num_layers"]
                  * model.params["graph_num_timesteps_per_layer"])
        branch = batch_branch(rs, model, batch.graph)
        if fault == "other_branch" and branch == "RGAT-fused":
            branch = "RGAT-streamed"
        want = expected_launches(branch, layers, 1, n_bwd,
                                 streamed_types(batch.graph))
        for k, n in want.items():
            rs.LAUNCHES[k] += n
        rs.FORM_LAUNCHES["rgat_src_bwd gather"] += want["rgat_src_bwd"]
        if fault == "extra_launch" and not n_bwd:
            rs.LAUNCHES["segsum"] += 1

    def train_step(self, batch):
        count(self, batch, 1)
        return real["train"](self, batch)

    def eval_step(self, batch):
        count(self, batch, 0)
        return real["eval"](self, batch)

    monkeypatch.setattr(SparseGraphModel, "_train_step", train_step)
    monkeypatch.setattr(SparseGraphModel, "_eval_step", eval_step)


@pytest.fixture(scope="module")
def tiny_ppi(tmp_path_factory):
    """Synthetic PPI folds of 3 / 1 / 1 graphs of 60-119 nodes."""
    from tf_gnn_samples_torch.tools.synthetic_data import make_synthetic_ppi

    return make_synthetic_ppi(str(tmp_path_factory.mktemp("tiny_ppi")),
                              seed=0, folds={"train": 3, "valid": 1,
                                             "test": 1},
                              min_nodes=60, max_nodes=120,
                              fwd_edges_per_node=6)


TINY = {"graph_num_layers": 1, "hidden_size": 16, "max_nodes_in_batch": 200}


@pytest.mark.parametrize("fault", ["none", "extra_launch", "other_branch",
                                   "metric_line", "loss_not_finite"])
def test_ppi_phase_checks_reject_planted_faults(tiny_ppi, tmp_path,
                                                monkeypatch, fault):
    """The PPI phase (task_phase) on the CPU at a tiny width, launches
    emulated per batch: all seven families and RGCN forced onto K5 pass
    through the train and test CLIs (GNN-Edge-MLP1's type-major branch
    over PPI's two streamed edge types); over three of them (RGAT's fused
    pass, GNN-Edge-MLP1, RGCN on K5) it fails on an eval step that
    launches one kernel more, steps that launch another branch's
    kernels, a micro-F1 line run_ppi_benchs.py's regex cannot read and a
    loss that is not finite."""
    import run_ppi_benchs
    from tf_gnn_samples_torch.tasks.ppi import PPI_Task

    assert MICRO_F1.pattern == run_ppi_benchs.SCRAPE["micro_f1"].pattern
    emulate_branch_launches(monkeypatch, fault)
    if fault == "metric_line":
        monkeypatch.setattr(PPI_Task, "pretty_print_epoch_task_metrics",
                            lambda self, results, n: "Avg MicroF1: nan")
    if fault == "loss_not_finite":
        real = PPI_Task.output_apply

        def output_apply(self, *args, **kwargs):
            loss, metrics = real(self, *args, **kwargs)
            return loss * float("nan"), dict(metrics, loss=loss * float(
                "nan"))

        monkeypatch.setattr(PPI_Task, "output_apply", output_apply)
    paths = (Path("PPI RGAT", "RGAT", {}), Path("PPI GNN-Edge-MLP1",
                                                 "GNN-Edge-MLP1", {}),
             Path("PPI RGCN K5", "RGCN", {"aggregation_strategy": "pallas"}))
    kwargs = dict(out=str(tmp_path), device="cpu", overrides=TINY,
                  profile=False)
    if fault == "none":
        # All seven families through the train and test CLIs, and RGCN
        # forced onto K5.
        total, results = task_phase(rs, "PPI", tiny_ppi,
                                    PPI_PATHS + paths[2:], 2, **kwargs)
        steps = {label: {branch for _, branch, _ in r["steps"]}
                 for label, r in results.items()}
        assert steps == {"PPI GNN-FiLM": {"GNN-FiLM"},
                         "PPI GNN-Edge-MLP0": {"GNN-Edge-MLP0"},
                         "PPI GNN-Edge-MLP1": {"GNN-Edge-MLP1"},
                         "PPI RGAT": {"RGAT-fused"}, "PPI RGCN": {"none"},
                         "PPI GGNN": {"none"}, "PPI RGIN": {"RGIN"},
                         "PPI RGCN K5": {"RGCN"}}
        # Two streamed edge types (fwd and the untied backward), one K12b
        # launch over both a layer on each train step.
        n_train = sum(n for (step, branch, _), n in
                      results["PPI GNN-Edge-MLP1"]["steps"].items()
                      if step == "_train_step")
        assert results["PPI GNN-Edge-MLP1"]["launches"]["act_agg_bwd"] == (
            n_train) > 0
        assert all(0 < r["metric"] < 1 for r in results.values())
        return
    match = {"extra_launch": "launches", "other_branch": "launches",
             "metric_line": "MicroF1", "loss_not_finite": "loss"}[fault]
    with pytest.raises(AssertionError, match=match):
        task_phase(rs, "PPI", tiny_ppi, paths, 2, **kwargs)


@pytest.mark.parametrize("fault", ["none", "not_cached"])
def test_ppi_headline_checks_reject_planted_faults(tiny_ppi, tmp_path,
                                                   monkeypatch, fault):
    """ppi_headline on the CPU at a tiny width: dense and K5 runs, their
    launches emulated, three epochs' train edges/s read from the log; it
    fails where the batches were not kept on the card."""
    emulate_branch_launches(monkeypatch)
    overrides = dict(TINY)
    if fault == "not_cached":
        overrides["cache_batches_on_device"] = False
    kwargs = dict(out=str(tmp_path), device="cpu", overrides=overrides,
                  profile=False)
    if fault == "none":
        total, rates = ppi_headline(rs, tiny_ppi, **kwargs)
        assert set(rates) == {"auto", "pallas"}
        assert all(len(v) == 2 and min(v) > 0 for v in rates.values())
        assert total["segsum"] > 0 and total["expand"] > 0
        return
    with pytest.raises(AssertionError, match="cached folds"):
        ppi_headline(rs, tiny_ppi, **kwargs)


@pytest.mark.parametrize("fault", ["none", "metric_line", "extra_launch"])
def test_citation_phase_checks_reject_planted_faults(tmp_path, monkeypatch,
                                                     fault):
    """The citation phase (task_phase) on the CPU at a tiny width on a
    small synthetic
    Planetoid graph: it passes as it is, and fails on an accuracy line
    that does not parse and an eval step that launches one kernel more."""
    from tf_gnn_samples_torch.tasks.citation import Citation_Network_Task
    from tf_gnn_samples_torch.tools.synthetic_data import (
        make_synthetic_planetoid)

    data = make_synthetic_planetoid(str(tmp_path / "pubmed"), seed=1,
                                    num_nodes=900, num_edges=1500,
                                    num_features=20, num_train=30,
                                    num_test=100)
    emulate_branch_launches(monkeypatch, fault)
    if fault == "metric_line":
        monkeypatch.setattr(Citation_Network_Task,
                            "pretty_print_epoch_task_metrics",
                            lambda self, results, n: "Acc: nan%")
    kwargs = dict(out=str(tmp_path), device="cpu", overrides=TINY,
                  task_overrides={"data_kind": "pubmed"}, metric=ACCURACY,
                  profile=False)
    paths = (Path("Pubmed GNN-FiLM", "GNN-FiLM", {}),
             Path("Pubmed RGCN", "RGCN", {}))
    if fault == "none":
        total, results = task_phase(rs, "CitationNetwork", data, paths, 3,
                                    **kwargs)
        assert total["film_fwd"] > 0
        assert all(0 <= r["metric"] <= 100 for r in results.values())
        return
    match = {"metric_line": "Acc", "extra_launch": "launches"}[fault]
    with pytest.raises(AssertionError, match=match):
        task_phase(rs, "CitationNetwork", data, paths, 3, **kwargs)


@pytest.mark.parametrize("fault", ["none", "loss_off", "gradient_off",
                                   "loss_nan"])
def test_reference_check_rejects_planted_faults(fault):
    """reference_agrees: last-bit differences pass; a loss 2 % off, one
    tensor's gradient 10 % off and a NaN loss fail."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(20, 8, generator=gen, dtype=torch.float64)
             for _ in range(3)]
    card = [g * (1 + 1e-6) for g in grads]
    loss = 3.25
    card_loss = loss * (1 + 1e-6)
    if fault == "loss_off":
        card_loss = loss * 1.02
    if fault == "gradient_off":
        card[1] = card[1] * 1.1
    if fault == "loss_nan":
        card_loss = float("nan")
    args = ("x", card_loss, card, loss, grads, 1e-6, {})
    if fault == "none":
        reference_agrees(*args)
        return
    with pytest.raises(AssertionError, match="disagree"):
        reference_agrees(*args)


# ---- the VarMisuse phase ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny_vm(tmp_path_factory):
    """Synthetic VarMisuse folds of 6 / 2 / 2 graphs of 30-59 nodes, the
    train fold in two shards (so that the streamed fold has a parse
    pool)."""
    from tf_gnn_samples_torch.tools.synthetic_data import (
        make_synthetic_varmisuse)

    return make_synthetic_varmisuse(
        str(tmp_path_factory.mktemp("tiny_vm")), seed=0,
        folds={"train": 6, "valid": 2, "test": 2}, min_nodes=30,
        max_nodes=60, per_chunk=3)


@pytest.fixture
def one_torch_thread():
    """The VarMisuse and scan phases at a tiny width run small tensors: with
    one intra-op thread a worker of the parallel test run does not
    oversubscribe the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# At the tiny batches RGCN's and GGNN's gate takes the dense matmuls;
# "pallas" keeps every family on its kernel branch, as at the tuned sizes.
VM_TINY = dict(TINY, aggregation_strategy="pallas", max_nodes_in_batch=150)


@pytest.mark.usefixtures("one_torch_thread")
def test_varmisuse_branches_of_the_seven_tuned_configs(tiny_vm, tmp_path):
    """batch_branch on a 22 / 23-type VarMisuse batch for the seven tuned
    configs (at the tiny width, "pallas" for RGCN's and GGNN's small
    batches): each answers its kernel branch, and the scan where asked."""
    from chip_smoke import VARMISUSE_PATHS, varmisuse_batch, varmisuse_params

    got = {}
    for path in VARMISUSE_PATHS:
        for scan in ("auto", "scan"):
            cls, params, task_params = varmisuse_params(
                path.model, dict(VM_TINY, typed_edge_scan=scan))
            task, batch = varmisuse_batch(
                os.path.join(tiny_vm, "graphs-valid"), 150, **task_params)
            assert batch.graph.num_edge_types == 22 + bool(
                task_params["add_self_loop_edges"])
            model = cls(params, task, "b", str(tmp_path), device="cpu")
            got[path.model, scan] = batch_branch(rs, model, batch.graph)
    rgat = got["RGAT", "auto"]
    assert rgat in ("RGAT-fused", "RGAT-streamed")
    assert got == {
        ("GNN-FiLM", "auto"): "GNN-FiLM", ("GNN-FiLM", "scan"): "GNN-FiLM",
        ("GNN-Edge-MLP0", "auto"): "GNN-Edge-MLP0",
        ("GNN-Edge-MLP0", "scan"): "none",
        ("GNN-Edge-MLP1", "auto"): "GNN-Edge-MLP1",
        ("GNN-Edge-MLP1", "scan"): "none",
        ("RGAT", "auto"): rgat, ("RGAT", "scan"): rgat,
        ("RGCN", "auto"): "RGCN", ("RGCN", "scan"): "RGCN",
        ("GGNN", "auto"): "GGNN", ("GGNN", "scan"): "GGNN",
        ("RGIN", "auto"): "RGIN", ("RGIN", "scan"): "none"}


@pytest.mark.parametrize("fault", ["none", "extra_launch", "not_streamed",
                                   "no_kernel_branch", "metric_line"])
@pytest.mark.usefixtures("one_torch_thread")
def test_varmisuse_phase_checks_reject_planted_faults(tiny_vm, tmp_path,
                                                      monkeypatch, fault):
    """The VarMisuse phase on the CPU at a tiny width, launches emulated
    per batch, over GNN-FiLM (its train fold streamed through its parse
    pool, which is closed after), GNN-Edge-MLP1 (its type-major branch:
    22 K12b launches a layer on each train step) and RGCN (K5) through
    the train and test CLIs, over 22 / 23 edge types, and the parse rates
    read (the seven families' branches: the test above). Over GNN-FiLM it
    fails on an eval step that launches one kernel more, a streamed fold
    that was loaded in memory, a batch on a branch without hand kernels
    and an accuracy line that run_varmisuse_benchs.py's regex cannot
    read."""
    import run_varmisuse_benchs
    from chip_smoke import (VARMISUSE_ACCURACY, VARMISUSE_PATHS, parse_rates,
                            varmisuse_phase)
    from tf_gnn_samples_torch.tasks.varmisuse import VarMisuse_Task

    assert VARMISUSE_ACCURACY.pattern == (
        run_varmisuse_benchs.SCRAPE_EVAL["testonly_acc"].pattern)
    emulate_branch_launches(monkeypatch, fault)
    overrides = dict(VM_TINY)
    if fault == "not_streamed":
        real = VarMisuse_Task.load_data

        def load_data(self, path):
            self.params["streaming_train_data"] = False
            return real(self, path)

        monkeypatch.setattr(VarMisuse_Task, "load_data", load_data)
    if fault == "no_kernel_branch":
        overrides["aggregation_strategy"] = "segment"
    if fault == "metric_line":
        monkeypatch.setattr(VarMisuse_Task, "pretty_print_epoch_task_metrics",
                            lambda self, results, n: "Accuracy: nan")
    kwargs = dict(out=str(tmp_path), device="cpu", overrides=overrides,
                  profile=False)
    if fault == "none":
        paths = tuple(p for p in VARMISUSE_PATHS if p.model in (
            "GNN-FiLM", "GNN-Edge-MLP1", "RGCN"))
        total, results = varmisuse_phase(rs, tiny_vm, paths=paths, **kwargs)
        steps = {label: {branch for _, branch, _ in r["steps"]}
                 for label, r in results.items()}
        assert steps == {"VarMisuse GNN-FiLM": {"GNN-FiLM"},
                         "VarMisuse GNN-Edge-MLP1": {"GNN-Edge-MLP1"},
                         "VarMisuse RGCN": {"RGCN"}}
        res = results["VarMisuse GNN-Edge-MLP1"]
        n_train = sum(n for (step, _, _), n in res["steps"].items()
                      if step == "_train_step")
        # 22 streamed types, one K12b launch over them a layer (the tiny
        # config's one layer) on each train step.
        assert res["launches"]["act_agg_bwd"] == n_train > 0
        assert all(0 <= r["metric"] <= 1 for r in results.values())
        assert not multiprocessing.active_children()
        rates = parse_rates(tiny_vm, workers=2)
        assert set(rates) == {(0, 1), (2, 1), (2, 2)}
        assert not multiprocessing.active_children()
        return
    paths = tuple(p for p in VARMISUSE_PATHS if p.model == "GNN-FiLM")
    match = {"extra_launch": "launches", "not_streamed": "streamed",
             "no_kernel_branch": "kernel branch",
             "metric_line": "Accuracy"}[fault]
    with pytest.raises(AssertionError, match=match):
        varmisuse_phase(rs, tiny_vm, paths=paths, **kwargs)
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("fault", ["none", "scan_drops_a_type",
                                   "scan_takes_kernels"])
@pytest.mark.usefixtures("one_torch_thread")
def test_scan_phase_checks_reject_planted_faults(tiny_vm, tmp_path,
                                                 monkeypatch, fault):
    """The scan phase on the CPU at a tiny width (RGIN, GNN-Edge-MLP1 and
    RGDCN at "scan" against "unroll"): it passes as it is, and fails on a
    scan that drops one edge type's messages and on a "scan" that takes
    RGIN's kernel branch."""
    from chip_smoke import scan_phase
    from tf_gnn_samples_torch.nn import layers

    if fault == "scan_drops_a_type":
        real = layers.scan_types_aggregate

        def scan(graph, te, msgs_fn, out_dim, aggregation):
            return real(graph, te, lambda l, te_l: msgs_fn(l, te_l) * (l > 0),
                        out_dim, aggregation)

        monkeypatch.setattr(layers, "scan_types_aggregate", scan)
    if fault == "scan_takes_kernels":
        real_branch = layers.rgin_branch

        def rgin_branch(graph, **kw):
            b = real_branch(graph, **kw)
            return "ranked" if b == "scanned" else b

        monkeypatch.setattr(layers, "rgin_branch", rgin_branch)
    kwargs = dict(out=str(tmp_path), device="cpu", profile=False,
                  overrides={"graph_num_layers": 1, "hidden_size": 16,
                             "max_nodes_in_batch": 150})
    if fault == "none":
        results = scan_phase(torch, rs, tiny_vm, **kwargs)
        assert {m: {k: v["branch"] for k, v in r.items()}
                for m, r in results.items()} == {
            "RGIN": {"scan": "none", "unroll": "none", "auto": "RGIN"},
            "GNN-Edge-MLP1": {"scan": "none", "unroll": "none",
                              "auto": "GNN-Edge-MLP1"},
            "RGDCN": {"scan": "none", "unroll": "none", "auto": "none"}}
        return
    match = {"scan_drops_a_type": "disagree",
             "scan_takes_kernels": "scan"}[fault]
    with pytest.raises(AssertionError, match=match):
        scan_phase(torch, rs, tiny_vm, **kwargs)


# ---- the scanned-epochs phase -------------------------------------------

def test_replay_checks_reject_planted_faults():
    """replay_eager_check, class by class in norms: a replay within twice
    the spread of the eager runs (plus SLACK_ULPS ulps at the class's
    largest magnitude) passes, one past it fails, where the eager runs
    agree bit for bit the replay may move only last bits of its largest
    entries, and an entry near zero
    that the atomics reach in every run does not let a 1% error in a large
    entry pass; fresh_masks_check: equal losses and weights with dropout
    on fail (equal losses with weights apart pass), unequal losses or
    weights with it off fail; replay_launch_check: a replay that
    counts fewer launches fails."""
    ulp = 2.0 ** -23  # at 1.0
    one = torch.ones(3)
    eager = [{"loss": [torch.tensor(1.0 + k * ulp)], "parameters": [one]}
             for k in (0, 3, 1)]
    near = {"loss": [torch.tensor(1.0 + 6 * ulp)], "parameters": [one]}
    noise = replay_eager_check("t", eager, near)
    assert noise == {"loss": 6 * ulp, "parameters": 0.0}
    for cls in ("loss", "parameters"):
        bad = {k: [v[0].clone()] for k, v in near.items()}
        bad[cls][0] += 6 * ulp
        with pytest.raises(AssertionError, match="over twice the spread"):
            replay_eager_check("t", eager, bad)
    flip = {"loss": near["loss"], "parameters": [one + torch.tensor(
        [ulp, 0.0, 0.0])]}
    replay_eager_check("t", eager, flip)
    # A slot near zero that the atomics move in every run by many of its
    # own ulps, beside O(0.1) entries; a 1% error in one of those fails.
    rng = np.random.RandomState(0)
    base = torch.from_numpy(rng.uniform(0.05, 0.2, 4096).astype(np.float32))
    base[0] = 1e-20

    def noisy(k):
        x = base.clone()
        x[0] = 1e-20 * (1 + k)
        return {"slots": [x]}

    runs = [noisy(k) for k in range(4)]
    replay_eager_check("t", runs, noisy(5))
    wrong = noisy(2)
    wrong["slots"][0][7] *= 1.01
    with pytest.raises(AssertionError, match="slots differ"):
        replay_eager_check("t", runs, wrong)
    def step(loss, weight=1.0):
        return {"loss": [torch.tensor(loss)],
                "parameters": [one * weight]}

    noise = {"loss": 2 * ulp, "parameters": 2 * ulp}
    fresh_masks_check("t", [step(1.0), step(1.1, 1.1)],
                      [step(1.0), step(1.0)], {"loss": 0.0,
                                               "parameters": 0.0})
    # The loss rounded to one value by two draws, the weights apart.
    fresh_masks_check("t", [step(1.0), step(1.0, 1.0 + 8 * ulp)],
                      [step(1.0), step(1.0)], noise)
    with pytest.raises(AssertionError, match="same dropout masks"):
        fresh_masks_check("t", [step(1.0), step(1.0 + 2 * ulp)],
                          [step(1.0), step(1.0)], noise)
    with pytest.raises(AssertionError, match="without dropout differ"):
        fresh_masks_check("t", [step(1.0), step(1.1, 1.1)],
                          [step(1.0), step(1.0 + 3 * ulp)], noise)
    with pytest.raises(AssertionError, match="without dropout differ"):
        fresh_masks_check("t", [step(1.0), step(1.1, 1.1)],
                          [step(1.0), step(1.0, 1.0 + 8 * ulp)], noise)
    replay_launch_check("t", {"segsum": 8}, {"segsum": 8})
    with pytest.raises(AssertionError, match="replayed step counts"):
        replay_launch_check("t", {"segsum": 8}, {})


@pytest.mark.parametrize("fault", ["one_draw_off", "every_draw_off"])
def test_replay_eager_redrawn_fails_only_where_every_draw_is_off(fault):
    """replay_eager_redrawn: a replay off its limit at the first draw and
    on it at the second (a rare rounding the eager runs did not draw)
    passes after two draws; a replay 1% off in one entry at every draw
    (a fault in the captured graph) fails after REPLAY_DRAWS draws, each
    of EAGER_STEPS fresh eager runs, with replay_eager_check's message."""
    rng = np.random.RandomState(0)
    base = torch.from_numpy(rng.uniform(0.05, 0.2, 4096).astype(np.float32))
    calls = {"eager": 0, "replay": 0}

    def eager_run():
        calls["eager"] += 1
        return {"parameters": [base.clone()]}

    def replay_run():
        calls["replay"] += 1
        x = base.clone()
        if fault == "every_draw_off" or calls["replay"] == 1:
            x[7] *= 1.01
        return {"parameters": [x]}

    if fault == "one_draw_off":
        noise = replay_eager_redrawn("t", eager_run, replay_run)
        assert noise == {"parameters": 0.0}
        assert calls == {"eager": 2 * EAGER_STEPS, "replay": 2}
        return
    with pytest.raises(AssertionError,
                       match="t, draw %d: the replayed run's parameters "
                             "differ" % REPLAY_DRAWS):
        replay_eager_redrawn("t", eager_run, replay_run)
    assert calls == {"eager": REPLAY_DRAWS * EAGER_STEPS,
                     "replay": REPLAY_DRAWS}


@pytest.mark.parametrize("fault", ["none", "derivative_one_at_clamp"])
def test_clamped_exp_check_rejects_a_derivative_of_one(monkeypatch, fault):
    from tf_gnn_samples_torch.ops import edge_ops

    if fault != "none":
        monkeypatch.setattr(edge_ops, "_clamped_exp", lambda x, c: torch.exp(
            torch.clamp(x, -c, c)))
        with pytest.raises(AssertionError, match="derivative"):
            clamped_exp_check(torch, edge_ops, torch.device("cpu"))
        return
    clamped_exp_check(torch, edge_ops, torch.device("cpu"))


@pytest.mark.parametrize("fault", [
    "none", "replay_differs", "identical_masks", "replay_adds_no_launches",
    "stale_batch"])
def test_scanned_epochs_phase_checks_reject_planted_faults(qm9_dir, tmp_path,
                                                           monkeypatch, fault):
    """scanned_epochs_phase on the CPU for GNN-FiLM at a tiny width (one
    layer, 16 columns, 600-node batches), where a scanned step runs
    eagerly and every step's launches are emulated (expected_launches for
    its batch): it passes as it is, and fails on a scanned train step
    whose parameters move off the eager step's, on replays that reseed the
    dropout generator alike, on scanned steps that count no launches and
    on scanned train steps past the first that read the batch before
    theirs (a stale pointer in a later capture, which one replayed step
    of batch 0 does not show and a whole scanned epoch does)."""
    assert "QM9 GNN-FiLM" in REPLAY_CHECKED
    monkeypatch.setattr(rs, "LAUNCHES", dict.fromkeys(rs.LAUNCHES, 0))

    def emulated(real, n_bwd):
        def step(self, batch):
            layers = (self.params["graph_num_layers"]
                      * self.params["graph_num_timesteps_per_layer"])
            for k, n in expected_launches("GNN-FiLM", layers, 1,
                                          n_bwd).items():
                rs.LAUNCHES[k] += n
            return real(self, batch)
        return step

    monkeypatch.setattr(SparseGraphModel, "_train_step_body", emulated(
        SparseGraphModel._train_step_body, 1))
    monkeypatch.setattr(SparseGraphModel, "_eval_step", emulated(
        SparseGraphModel._eval_step, 0))
    real_scanned = SparseGraphModel._scanned_step

    def scanned(self, fold, i, batch):
        if fault == "identical_masks":
            self._dropout_gen.manual_seed(5)
        if fault == "stale_batch" and fold.name == "TRAIN" and i:
            batch = self._batch_cache[fold][i - 1]
        saved = dict(rs.LAUNCHES)
        metrics = real_scanned(self, fold, i, batch)
        if fault == "replay_adds_no_launches":
            rs.LAUNCHES.update(saved)
        if fault == "replay_differs" and fold.name == "TRAIN":
            with torch.no_grad():
                self._leaves()[0].add_(1e-3)
        return metrics

    monkeypatch.setattr(SparseGraphModel, "_scanned_step", scanned)
    kwargs = dict(data={"qm9": qm9_dir}, out=str(tmp_path), device="cpu",
                  overrides={"graph_num_layers": 1, "hidden_size": 16,
                             "max_nodes_in_batch": 600},
                  paths=((Path("QM9 GNN-FiLM", "GNN-FiLM", {}), "QM9",
                          "qm9"),), timed=False)
    if fault == "none":
        launches = scanned_epochs_phase(rs, **kwargs)
        # 4 train and 2 valid batches an epoch: 4 + 2 epochs, 1 layer
        assert launches["film_fwd"] == 6 * 6
        return
    match = {"replay_differs": "replayed run's parameters differ",
             "identical_masks": "same dropout masks",
             "replay_adds_no_launches": "launches",
             "stale_batch": "scanned epoch .* differ"}[fault]
    with pytest.raises(AssertionError, match=match):
        scanned_epochs_phase(rs, **kwargs)


# ---- RGCN's layer with source and target states ---------------------------

class _DhFault(torch.autograd.Function):
    """The identity forward; the backward plants `fault` in d_h: one row
    (the largest) 1% off, or every entry rounded to bf16."""

    @staticmethod
    def forward(ctx, h, fault):
        ctx.fault = fault
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if ctx.fault == "one_row":
            g[int(g.norm(dim=1).argmax())] *= 1.01
        elif ctx.fault == "bf16_d_h":
            g = g.to(torch.bfloat16).float()
        return g, None


@pytest.mark.parametrize("fault", ["none", "one_row", "bf16_d_h"])
def test_rgcn_src_and_tgt_check_rejects_planted_faults(monkeypatch, fault):
    """rgcn_src_and_tgt_check on the CPU on the first 600-node pack of 200
    QM9 valid graphs (10,240 edges, whole 2,048-edge rows, so the target
    half takes the ranked gather), the card's run emulated (its launches
    counted, the plain versions in place of the kernels): it passes as it
    is, and fails on one row of d_h 1% off and on d_h rounded to bf16."""
    from chip_smoke import rgcn_src_and_tgt_check
    from tf_gnn_samples_torch.nn import layers
    from tf_gnn_samples_torch.tasks import base as t_base
    from tf_gnn_samples_torch.tasks import qm9 as t_qm9

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    task = t_qm9.QM9_Task(t_qm9.QM9_Task.default_params())
    data = task._QM9_Task__load_data(
        os.path.join(root, "data", "qm9", "valid.jsonl.gz"))[:200]
    graph = next(task.make_minibatch_iterator(
        data, t_base.DataFold.VALIDATION, 600)).graph
    assert graph.flat.tgt_flat.shape[0] == 10240
    monkeypatch.setattr(rs, "LAUNCHES", dict.fromkeys(rs.LAUNCHES, 0))
    real, calls = layers.rgcn_apply, []

    def planted(params, g, h, **kwargs):
        calls.append(kwargs)
        if len(calls) == 1:  # the card's run comes first
            rs.LAUNCHES["segsum"] += 2
            rs.LAUNCHES["expand"] += 1
            h = _DhFault.apply(h, fault)
        return real(params, g, h, **kwargs)

    monkeypatch.setattr(layers, "rgcn_apply", planted)
    if fault == "none":
        assert rgcn_src_and_tgt_check(torch, rs, graph, width=32) == 0.0
    else:
        with pytest.raises(AssertionError, match="d_h off the CPU's"):
            rgcn_src_and_tgt_check(torch, rs, graph, width=32)
    assert all(k["use_both_source_and_target"] for k in calls)
