"""The port's PPI task against the JAX package's, on the CPU: the loader
(every graph's adjacency lists, incoming counts, features and labels),
the packed batches field by field for the same numpy seed (also with
batch_spec_buckets 3 over graphs of varied size), the head (loss,
total_loss and micro-F1 from the same final states and weights),
GNN-FiLM's and RGAT's loss and gradients at hidden 32 and 2 layers, the
planted fixture's learnability, the CLIs, a JAX checkpoint restored in
the port, and the data that tools/synthetic_data.py writes."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import run_ppi_benchs
from fixtures import make_planted_ppi_dir, make_ppi_dir
from test_torch_graph import assert_graphs_equal
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import ppi as j_ppi
from tf_gnn_samples_tpu.utils import registry as j_registry
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import ppi as t_ppi
from tf_gnn_samples_torch.tools.synthetic_data import make_synthetic_ppi
from tf_gnn_samples_torch.utils import registry as t_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TASK_VARIANTS = [{}, {"tie_fwd_bkwd_edges": True},
                 {"add_self_loop_edges": False}]


@pytest.fixture(scope="module")
def ppi_dir(tmp_path_factory):
    return make_ppi_dir(str(tmp_path_factory.mktemp("ppi")))


@pytest.fixture(scope="module")
def varied_dir(tmp_path_factory):
    """PPI-format folds of 10 / 3 / 3 graphs of 100-399 nodes (the port's
    synthetic data maker), so that packs differ in size and the batch
    spec buckets take several levels."""
    return make_synthetic_ppi(str(tmp_path_factory.mktemp("ppi_varied")),
                              seed=3, folds={"train": 10, "valid": 3,
                                             "test": 3},
                              min_nodes=100, max_nodes=400,
                              fwd_edges_per_node=6)


def load(mod, root, **params):
    task = mod.PPI_Task(dict(mod.PPI_Task.default_params(), **params))
    task.load_data(root)
    return task


def assert_samples_equal(tdata, jdata):
    assert len(tdata) == len(jdata)
    for t, j in zip(tdata, jdata):
        assert len(t.adjacency_lists) == len(j.adjacency_lists)
        for a, b in zip(t.adjacency_lists, j.adjacency_lists):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for field in ("type_to_node_to_num_incoming_edges", "node_features",
                      "node_labels"):
            a, b = getattr(t, field), getattr(j, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("params", TASK_VARIANTS)
def test_loader_equals_jax(ppi_dir, params):
    jt, tt = load(j_ppi, ppi_dir, **params), load(t_ppi, ppi_dir, **params)
    assert tt.num_edge_types == jt.num_edge_types == (
        3 - ("add_self_loop_edges" in params) - ("tie_fwd_bkwd_edges"
                                                 in params))
    assert tt.initial_node_feature_size == jt.initial_node_feature_size == 50
    assert tt.get_metadata() == jt.get_metadata()
    assert tt.get_metadata()["num_labels"] == 121
    for fold in ("TRAIN", "VALIDATION"):
        assert_samples_equal(tt._loaded_data[t_base.DataFold[fold]],
                             jt._loaded_data[j_base.DataFold[fold]])
    assert_samples_equal(tt.load_eval_data_from_path(ppi_dir),
                         jt.load_eval_data_from_path(ppi_dir))


@pytest.mark.parametrize("data, buckets, max_nodes, fold", [
    ("fixture", 3, 700, "TRAIN"), ("fixture", 3, 350, "VALIDATION"),
    ("varied", 3, 900, "TRAIN"), ("varied", 1, 900, "TRAIN"),
    ("varied", 3, 500, "VALIDATION")])
def test_batches_equal_jax(ppi_dir, varied_dir, data, buckets, max_nodes,
                           fold):
    root = ppi_dir if data == "fixture" else varied_dir
    jt = load(j_ppi, root, batch_spec_buckets=buckets)
    tt = load(t_ppi, root, batch_spec_buckets=buckets)
    batches = []
    for task, base in ((jt, j_base), (tt, t_base)):
        np.random.seed(11)  # TRAIN shuffles with the global numpy RNG
        batches.append(list(task.make_minibatch_iterator(
            task._loaded_data[base.DataFold[fold]], base.DataFold[fold],
            max_nodes)))
    jbs, tbs = batches
    assert len(tbs) == len(jbs) > 1
    for tb, jb in zip(tbs, jbs):
        assert_graphs_equal(tb.graph, jb.graph)
        assert (tb.num_graphs, tb.num_nodes, tb.num_edges) == (
            jb.num_graphs, jb.num_nodes, jb.num_edges)
        labels = tb.aux["target_labels"]
        assert labels.dtype == torch.float32
        assert np.array_equal(labels.numpy(), jb.aux["target_labels"])
    if data == "varied" and buckets == 3 and fold == "TRAIN":
        assert len({tb.graph.n_pad for tb in tbs}) > 1


def head_inputs(tt, jt, batch_pair, seed=0, hidden=32):
    """The same final states, initial features and head weights for both
    packages (numpy, seeded): logits around 0, so the F1 counts mix."""
    rng = np.random.RandomState(seed)
    jb, tb = batch_pair
    final_h = rng.randn(tb.graph.n_pad, hidden).astype(np.float32)
    head = {"kernel": (0.3 * rng.randn(hidden, 121)).astype(np.float32),
            "bias": (0.1 * rng.randn(121)).astype(np.float32)}
    return final_h, head


@pytest.fixture(scope="module")
def fixture_batches(ppi_dir):
    """(JAX task, port task, [(JAX batch, port batch)]) of the fixture's
    valid fold at 350 nodes: one 300-node graph a batch."""
    jt, tt = load(j_ppi, ppi_dir), load(t_ppi, ppi_dir)
    jbs = list(jt.make_minibatch_iterator(
        jt._loaded_data[j_base.DataFold.VALIDATION],
        j_base.DataFold.VALIDATION, 350))
    tbs = list(tt.make_minibatch_iterator(
        tt._loaded_data[t_base.DataFold.VALIDATION],
        t_base.DataFold.VALIDATION, 350))
    return jt, tt, list(zip(jbs, tbs))


@pytest.mark.parametrize("seed", [0, 1])
def test_head_matches_jax(fixture_batches, seed):
    jt, tt, pairs = fixture_batches
    jb, tb = pairs[seed % len(pairs)]
    final_h, head = head_inputs(tt, jt, (jb, tb), seed)
    jloss, jmet = jt.output_apply({k: jnp.asarray(v) for k, v in head.items()},
                                  jb, jnp.asarray(final_h), None, None)
    tloss, tmet = tt.output_apply({k: torch.tensor(v) for k, v in head.items()},
                                  tb, torch.tensor(final_h), None, None)
    assert tmet.keys() == jmet.keys() == {"loss", "total_loss", "f1_score"}
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert 0.2 < float(tmet["f1_score"]) < 0.8
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    # Padded rows carry no loss and no counts: changing them moves nothing.
    moved = final_h.copy()
    moved[tb.num_nodes:] = 100.0
    _, tmet2 = tt.output_apply({k: torch.tensor(v) for k, v in head.items()},
                               tb, torch.tensor(moved), None, None)
    for k in tmet:
        assert float(tmet2[k]) == float(tmet[k]), k


def test_epoch_f1_is_the_mean_of_the_batches():
    """Avg MicroF1 averages the batches' F1, as the JAX package does; it
    is not an F1 of the pooled counts."""
    task = t_ppi.PPI_Task(t_ppi.PPI_Task.default_params())
    jtask = j_ppi.PPI_Task(j_ppi.PPI_Task.default_params())
    results = [{"f1_score": np.float32(0.25), "total_loss": np.float32(4)},
               {"f1_score": np.float32(0.5), "total_loss": np.float32(2)}]
    line = task.pretty_print_epoch_task_metrics(results, 3)
    assert line == jtask.pretty_print_epoch_task_metrics(results, 3)
    assert line == "Avg MicroF1: 0.375"
    assert run_ppi_benchs.SCRAPE["micro_f1"].match("Metrics: " + line)
    assert task.early_stopping_metric(results, 3) == 2.0


def small_params(model, **extra):
    """The tuned PPI_<model>.json hypers cut to hidden 32 and 2 layers,
    dropout off."""
    cls, extra_cls = j_registry.name_to_model_class(model)
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "PPI_%s.json" % model)) as f:
        hypers = json.load(f)["model_params"]
    params = cls.default_params()
    params.update(extra_cls)
    params.update(hypers)
    params.update({"hidden_size": 32, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 350})
    params.update(extra)
    return params


def test_hypers_are_copies():
    names = sorted(n for n in os.listdir(os.path.join(
        ROOT, "tf_gnn_samples_tpu", "default_hypers")) if n.startswith("PPI_"))
    assert len(names) == 7
    for name in names:
        with open(os.path.join(ROOT, "tf_gnn_samples_tpu", "default_hypers",
                               name)) as f, open(os.path.join(
                ROOT, "tf_gnn_samples_torch", "default_hypers", name)) as g:
            assert json.load(f) == json.load(g), name


@pytest.mark.parametrize("model", ["GNN-FiLM", "RGAT"])
@pytest.mark.parametrize("strategy", ["auto", "segment"])
def test_model_loss_and_grads_match_jax(fixture_batches, tmp_path,
                                        monkeypatch, model, strategy):
    """Loss and every parameter gradient on a 300-node fixture graph
    (diluted src stream), weights carried by params_from_jax. "segment":
    both packages' plain f32 branch (interpret mode off), at
    test_torch_model.py's tolerances (loss rtol 1e-5; a gradient entry
    rtol 1e-4 with atol 3e-4 of its tensor's largest entry; measured
    <= 1.0e-6). "auto": both on their kernel branch (GNN-FiLM's fused
    FiLM pass, RGAT's fused pass; the JAX Pallas kernels in interpret
    mode, the port's plain versions), bf16 message streams: a streamed
    value may round to the neighbouring bf16 number where the f32 matmul
    orders differ in a last bit, and here a receiver sums ~17 messages
    (QM9: ~3), so gradient entries move by up to 9.5e-4 of their tensor's
    largest (GNN-FiLM; RGAT 2.6e-4) and by 7.8e-4 in norm: held at 2e-3
    both ways, the loss at 1e-5 (measured 4.4e-7)."""
    kernels = strategy == "auto"
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", kernels)
    jt, tt, pairs = fixture_batches
    jb, tb = pairs[0]
    assert tb.graph.flat.win_sd  # the diluted src stream engaged
    params = small_params(model, aggregation_strategy=strategy)
    jcls, _ = j_registry.name_to_model_class(model)
    tcls, _ = t_registry.name_to_model_class(model)
    jm = jcls(dict(params), jt, "j", str(tmp_path))
    tm = tcls(dict(params), tt, "t", str(tmp_path), device="cpu")
    tm.load_weights(j_model.flatten_params(jm.model_params_tree))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jm._device_batch(jb), None), has_aux=True)(
            jm.model_params_tree)
    tloss, _ = tm._forward(tm.model_params_tree,
                           t_model.batch_to_device(tb, CPU), None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, tgrads):
        want = np.asarray(jflat[name])
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=(2e-3 if kernels else 3e-4) * scale,
                                   err_msg=name)
        if kernels:
            rel = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
            assert rel < 2e-3, (name, rel)


@pytest.mark.slow
def test_planted_fixture_reaches_micro_f1(tmp_path):
    """The port's head, loss and micro-F1 learn the planted fixture
    (label j = sign of feature j % 50) to train-fold micro-F1 >= 0.99, as
    tests/test_learnability.py holds the JAX package (RGCN, Adam 0.005,
    150 epochs, hidden 128, 2 layers). `slow` as that test is: some 3 s
    alone, but 350 s beside five other pytest workers (its 600 small
    steps, each op on every core)."""
    root = make_planted_ppi_dir(str(tmp_path / "ppi"))
    task = t_ppi.PPI_Task(t_ppi.PPI_Task.default_params())
    task.load_data(root)
    cls, _ = t_registry.name_to_model_class("RGCN")
    params = cls.default_params()
    params.update({"hidden_size": 128, "graph_num_layers": 2,
                   "optimizer": "Adam", "learning_rate": 0.005,
                   "max_epochs": 150, "patience": 10000,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 200, "random_seed": 0})
    model = cls(params, task, "learn", str(tmp_path), device="cpu")
    model.train(quiet=True)
    _, metrics, _, _, _, _ = model._run_epoch(
        "final", task._loaded_data[t_base.DataFold.TRAIN],
        t_base.DataFold.VALIDATION, quiet=True)
    f1 = float(np.average([m["f1_score"] for m in metrics]))
    assert f1 >= 0.99, f1


def eval_loss(model, base, path):
    data = model.task.load_eval_data_from_path(path)
    loss, metrics, graphs, _, _, _ = model._run_epoch(
        "Test", data, base.DataFold.TEST, quiet=True)
    return loss, float(np.average([m["f1_score"] for m in metrics])), graphs


def test_jax_checkpoint_restores_in_the_port(ppi_dir, tmp_path):
    """A PPI pickle the JAX package wrote restores in the port from its
    task metadata (num_labels) and gives the same test loss and F1 (both
    on the plain f32 segment branch)."""
    params = small_params("GNN-FiLM", aggregation_strategy="segment")
    jm = j_model.GNN_FiLM_Model(dict(params), load(j_ppi, ppi_dir), "j",
                                str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))
    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    assert tm.task.get_metadata()["num_labels"] == 121
    jres, tres = eval_loss(jm, j_base, ppi_dir), eval_loss(tm, t_base, ppi_dir)
    assert tres[2] == jres[2] == 2
    np.testing.assert_allclose(tres[:2], jres[:2], rtol=1e-5)


def test_train_and_test_clis(ppi_dir, tmp_path):
    """`python -m tf_gnn_samples_torch.train RGAT PPI --device cpu` trains
    1 epoch and writes the log lines run_ppi_benchs.py parses; the test
    CLI evaluates the checkpoint from its task metadata."""
    overrides = json.dumps({"max_epochs": 1, "hidden_size": 16,
                            "graph_num_layers": 2,
                            "max_nodes_in_batch": 700})
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "RGAT", "PPI",
         "--device", "cpu", "--data-path", ppi_dir, "--result-dir",
         str(tmp_path), "--quiet", "--model-param-overrides", overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = (r" %s: loss: \d+\.\d{5} \|\| Avg MicroF1: \d\.\d{3} \|\| "
            r"graphs/sec: \d+\.\d{2} \| nodes/sec: \d+ \| edges/sec: \d+$")
    lines = out.stdout.splitlines()
    assert any(re.match(line % "Train", l) for l in lines), out.stdout
    assert any(re.match(line % "Valid", l) for l in lines), out.stdout
    pickles = list(tmp_path.glob("PPI_RGAT_*_best_model.pickle"))
    assert len(pickles) == 1
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickles[0]), ppi_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^Loss \d+\.\d{5} on 2 graphs$", out.stdout, re.M)
    assert any(run_ppi_benchs.SCRAPE["micro_f1"].match(l)
               for l in out.stdout.splitlines()), out.stdout


def test_synthetic_ppi_has_the_published_statistics(tmp_path):
    """make_synthetic_ppi at its defaults, through both loaders: 20 / 2 / 2
    graphs of 1,700-3,099 nodes, 28 forward edges a node, 50 features and
    121 labels; the same seed writes the same files."""
    root = make_synthetic_ppi(str(tmp_path / "a"), seed=5)
    tt = load(t_ppi, root)
    jt = j_ppi.PPI_Task(j_ppi.PPI_Task.default_params())
    folds = {"TRAIN": tt._loaded_data[t_base.DataFold.TRAIN],
             "VALIDATION": tt._loaded_data[t_base.DataFold.VALIDATION],
             "TEST": tt.load_eval_data_from_path(root)}
    assert [len(v) for v in folds.values()] == [20, 2, 2]
    for samples in folds.values():
        for s in samples:
            n = s.node_features.shape[0]
            assert 1700 <= n < 3100
            assert s.node_features.shape == (n, 50)
            assert s.node_labels.shape == (n, 121)
            assert s.adjacency_lists[0].shape == (28 * n, 2)
            assert np.array_equal(s.adjacency_lists[1][:, 0], np.arange(n))
    assert_samples_equal(folds["VALIDATION"], jt._PPI_Task__load_data(
        root, j_base.DataFold.VALIDATION))
    small = {"train": 2, "valid": 1, "test": 1}
    a = make_synthetic_ppi(str(tmp_path / "b"), seed=5, folds=small,
                           min_nodes=50, max_nodes=60)
    b = make_synthetic_ppi(str(tmp_path / "c"), seed=5, folds=small,
                           min_nodes=50, max_nodes=60)
    for name in sorted(os.listdir(a)):
        with open(os.path.join(a, name), "rb") as f, open(
                os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
