"""The port's citation-network task against the JAX package's, on the
CPU, for cora and for citeseer (whose loader fills the test range's
isolated nodes): preprocess_features, the loaded splits, the single
padded batch field by field, the masked head (loss, total_loss and
accuracy from the same final states and weights, and its output dropout
drawn from the runtime's generator), a small model's loss and gradients,
the planted fixture's learnability, the CLIs, a JAX checkpoint restored in
the port, and the Pubmed-sized data of tools/synthetic_data.py."""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import make_planetoid_dir, make_planted_planetoid_dir
from test_torch_graph import assert_graphs_equal
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import citation as j_cit
from tf_gnn_samples_tpu.utils import registry as j_registry
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import citation as t_cit
from tf_gnn_samples_torch.tools.synthetic_data import make_synthetic_planetoid
from tf_gnn_samples_torch.utils import registry as t_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DATASETS = ("cora", "citeseer")


def drop_test_nodes(root, dataset, drop=(3, 17, 41)):
    """Make citeseer's isolated test nodes: the test index file and tx / ty
    lose a few entries inside the test range, which the loader fills with
    zero rows (citation_network_utils.py:58-67)."""
    with open(os.path.join(root, "ind.%s.test.index" % dataset)) as f:
        idx = [int(line) for line in f]
    keep = [i for i, _ in enumerate(sorted(idx)) if i not in drop]
    kept = set(sorted(idx)[i] for i in keep)
    objs = {}
    for name in ("tx", "ty"):
        with open(os.path.join(root, "ind.%s.%s" % (dataset, name)),
                  "rb") as f:
            objs[name] = pickle.load(f)
    for name, obj in objs.items():
        with open(os.path.join(root, "ind.%s.%s" % (dataset, name)),
                  "wb") as f:
            pickle.dump(obj[keep], f)
    with open(os.path.join(root, "ind.%s.test.index" % dataset), "w") as f:
        f.write("\n".join(str(i) for i in idx if i in kept))


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    dirs = {}
    for ds in DATASETS:
        root = make_planetoid_dir(str(tmp_path_factory.mktemp(ds)),
                                  dataset=ds)
        if ds == "citeseer":
            drop_test_nodes(root, ds)
        dirs[ds] = root
    return dirs


def load(mod, root, dataset, **params):
    cls = mod.Citation_Network_Task
    task = cls(dict(cls.default_params(), data_kind=dataset, **params))
    task.load_data(root)
    return task


def test_preprocess_features_equals_jax(data_dirs):
    import scipy.sparse as sp

    rng = np.random.RandomState(0)
    dense = (rng.rand(40, 12) < 0.3) * rng.rand(40, 12)
    dense[5] = 0.0  # a row without features keeps its zeros
    feats = sp.lil_matrix(dense)
    got, want = t_cit.preprocess_features(feats), j_cit.preprocess_features(
        feats)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    nonzero = dense.sum(1) != 0
    assert not nonzero[5] and nonzero.sum() > 30
    assert np.allclose(got.sum(1)[nonzero], 1.0)
    assert not got[~nonzero].any()
    for ds, root in data_dirs.items():
        got = t_cit.load_planetoid_data(root, ds)
        want = j_cit.load_planetoid_data(root, ds)
        assert got[0] == want[0]
        assert np.array_equal(got[1].toarray(), want[1].toarray())
        for a, b in zip(got[2:], want[2:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dataset", DATASETS)
def test_loader_and_batch_equal_jax(data_dirs, dataset):
    root = data_dirs[dataset]
    jt, tt = load(j_cit, root, dataset), load(t_cit, root, dataset)
    assert tt.get_metadata() == jt.get_metadata()
    assert tt.num_edge_types == jt.num_edge_types == 2
    folds = [(tt._loaded_data[t_base.DataFold[f]],
              jt._loaded_data[j_base.DataFold[f]], f)
             for f in ("TRAIN", "VALIDATION")]
    folds.append((tt.load_eval_data_from_path(root),
                  jt.load_eval_data_from_path(root), "TEST"))
    n = None
    for tdata, jdata, fold in folds:
        (td,), (jd,) = tdata, jdata
        for field in td._fields:
            a, b = getattr(td, field), getattr(jd, field)
            if field == "adj_lists":
                assert all(x.dtype == y.dtype and np.array_equal(x, y)
                           for x, y in zip(a, b))
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), field
        n = td.features.shape[0]
        (tb,) = tt.make_minibatch_iterator(tdata, t_base.DataFold[fold], 1)
        (jb,) = jt.make_minibatch_iterator(jdata, j_base.DataFold[fold], 1)
        assert_graphs_equal(tb.graph, jb.graph)
        assert (tb.num_graphs, tb.num_nodes, tb.num_edges) == (
            jb.num_graphs, jb.num_nodes, jb.num_edges) == (
                1, n, jb.num_edges)
        for key in ("labels", "mask"):
            assert np.array_equal(tb.aux[key].numpy(), jb.aux[key]), key
        assert tb.aux["labels"].dtype == torch.int32
    # The fixture's 700 nodes: self loops padded to 768 slots, not whole
    # 2048-edge rows, so neither package's ranked gate holds.
    assert n == 700 and tb.graph.n_pad == 768
    assert not t_layers.ranked_aggregation_ok(tb.graph, "sum")


@pytest.fixture(scope="module")
def cora(data_dirs):
    root = data_dirs["cora"]
    jt, tt = load(j_cit, root, "cora"), load(t_cit, root, "cora")
    (jb,) = jt.make_minibatch_iterator(
        jt._loaded_data[j_base.DataFold.TRAIN], j_base.DataFold.TRAIN, 1)
    (tb,) = tt.make_minibatch_iterator(
        tt._loaded_data[t_base.DataFold.TRAIN], t_base.DataFold.TRAIN, 1)
    return jt, tt, jb, tb


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_head_matches_jax(cora, seed):
    jt, tt, jb, tb = cora
    rng = np.random.RandomState(seed)
    final_h = rng.randn(tb.graph.n_pad, 16).astype(np.float32)
    kernel = rng.randn(16, 7).astype(np.float32)
    jloss, jmet = jt.output_apply({"kernel": jnp.asarray(kernel)}, jb,
                                  jnp.asarray(final_h), None, None)
    tloss, tmet = tt.output_apply({"kernel": torch.tensor(kernel)}, tb,
                                  torch.tensor(final_h), None, None)
    assert tmet.keys() == jmet.keys() == {"loss", "total_loss", "accuracy"}
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tmet["accuracy"]) < 1.0
    # Nodes outside the fold's mask, and padding, move nothing.
    moved = final_h.copy()
    moved[tb.aux["mask"].numpy() == 0] = 50.0
    _, tmet2 = tt.output_apply({"kernel": torch.tensor(kernel)}, tb,
                               torch.tensor(moved), None, None)
    for k in tmet:
        assert float(tmet2[k]) == float(tmet[k]), k


def test_output_dropout_draws_from_the_runtime_generator(cora):
    """With out_layer_dropout_keep_prob < 1 the head drops final states in
    training only (a generator given), drawing from that generator: the
    same seed gives the same loss, another seed another one, and the
    expectation is kept (inverted dropout)."""
    _, tt, _, tb = cora
    task = t_cit.Citation_Network_Task(dict(tt.params,
                                            out_layer_dropout_keep_prob=0.5))
    task.restore_from_metadata({"params": task.params,
                                **{k: v for k, v in tt.get_metadata().items()
                                   if k != "params"}})
    rng = np.random.RandomState(0)
    h = torch.tensor(rng.randn(tb.graph.n_pad, 16).astype(np.float32))
    kernel = {"kernel": torch.tensor(rng.randn(16, 7).astype(np.float32))}
    plain = float(task.output_apply(kernel, tb, h, None, None)[0])
    assert plain == float(tt.output_apply(kernel, tb, h, None, None)[0])

    def loss(seed):
        gen = torch.Generator().manual_seed(seed)
        return float(task.output_apply(kernel, tb, h, None, gen)[0])

    assert loss(3) == loss(3) != loss(4)
    assert plain not in (loss(3), loss(4))


def small_params(model, **extra):
    cls, extra_cls = j_registry.name_to_model_class(model)
    params = cls.default_params()
    params.update(extra_cls)
    params.update({"hidden_size": 32, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0})
    params.update(extra)
    return params


@pytest.mark.parametrize("model", ["GNN-FiLM", "RGCN"])
def test_model_loss_and_grads_match_jax(cora, tmp_path, model):
    """Loss and every parameter gradient at hidden 32 and 2 layers (class
    defaults otherwise, as no hypers file exists for the task), weights
    carried by params_from_jax, at test_torch_model.py's tolerances. Both
    packages run their plain f32 branch: at the fixture's size the JAX
    gates refuse the ranked kernels (768 self-loop slots are not whole
    2048-edge rows) and RGCN takes the dense matmuls in both. GNN-FiLM is
    set to "segment": the port's FiLM gate drops that whole-rows term (its
    CUDA kernels need none), so under "auto" it would take the bf16 fused
    pass where the JAX package takes the plain branch."""
    jt, tt, jb, tb = cora
    params = small_params(model, aggregation_strategy=(
        "segment" if model == "GNN-FiLM" else "auto"))
    assert t_layers.film_fused_branch("auto", "sum", "relu")
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
        scale = float(np.abs(jflat[name]).max())
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4,
                                   atol=3e-4 * scale, err_msg=name)


@pytest.mark.slow
def test_planted_fixture_reaches_accuracy(tmp_path):
    """The port's masked head learns the planted fixture (class = argmax of
    the first feature columns) to train-mask accuracy >= 0.95, as
    tests/test_learnability.py holds the JAX package (RGCN, Adam 0.01,
    200 epochs, hidden 64, 2 layers). `slow` as that test is: some 9 s
    alone, but 290 s beside five other pytest workers."""
    root = make_planted_planetoid_dir(str(tmp_path / "cit"))
    task = load(t_cit, root, "cora")
    cls, _ = t_registry.name_to_model_class("RGCN")
    params = cls.default_params()
    params.update({"hidden_size": 64, "graph_num_layers": 2,
                   "optimizer": "Adam", "learning_rate": 0.01,
                   "max_epochs": 200, "patience": 10000,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 1000, "random_seed": 0})
    model = cls(params, task, "learn", str(tmp_path), device="cpu")
    model.train(quiet=True)
    _, metrics, _, _, _, _ = model._run_epoch(
        "final", task._loaded_data[t_base.DataFold.TRAIN],
        t_base.DataFold.VALIDATION, quiet=True)
    assert float(metrics[0]["accuracy"]) >= 0.95, metrics


def test_jax_checkpoint_restores_in_the_port(data_dirs, tmp_path):
    """A citeseer pickle the JAX package wrote restores in the port from
    its task metadata and gives the same test loss and accuracy."""
    root = data_dirs["citeseer"]
    params = small_params("RGCN")
    jm = j_model.RGCN_Model(dict(params), load(j_cit, root, "citeseer"), "j",
                            str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))
    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    assert tm.task.params["data_kind"] == "citeseer"
    res = []
    for model, base in ((jm, j_base), (tm, t_base)):
        data = model.task.load_eval_data_from_path(root)
        loss, metrics, graphs, _, _, _ = model._run_epoch(
            "Test", data, base.DataFold.TEST, quiet=True)
        res.append((loss, float(metrics[0]["accuracy"]), graphs))
    assert res[0][2] == res[1][2] == 1
    np.testing.assert_allclose(res[1][:2], res[0][:2], rtol=1e-5)


def test_train_and_test_clis(data_dirs, tmp_path):
    """`python -m tf_gnn_samples_torch.train GNN-FiLM cora --device cpu`
    trains 2 epochs and logs the Acc lines; the test CLI evaluates the
    checkpoint from its task metadata."""
    root = data_dirs["cora"]
    overrides = json.dumps({"max_epochs": 2, "hidden_size": 16,
                            "graph_num_layers": 2})
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "GNN-FiLM",
         "cora", "--device", "cpu", "--data-path", root, "--result-dir",
         str(tmp_path), "--quiet", "--model-param-overrides", overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = (r" %s: loss: \d+\.\d{5} \|\| Acc: \d+\.\d{2}%% \|\| "
            r"graphs/sec: \d+\.\d{2} \| nodes/sec: \d+ \| edges/sec: \d+$")
    lines = out.stdout.splitlines()
    assert sum(bool(re.match(line % "Train", l)) for l in lines) == 2
    assert sum(bool(re.match(line % "Valid", l)) for l in lines) == 2
    pickles = list(tmp_path.glob("CitationNetwork_GNN-FiLM_*_best_model"
                                 ".pickle"))
    assert len(pickles) == 1
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickles[0]), root],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^Loss \d+\.\d{5} on 1 graphs$", out.stdout, re.M)
    assert re.search(r"^Metrics: Acc: \d+\.\d{2}%$", out.stdout, re.M)


def test_synthetic_pubmed_has_the_published_size(tmp_path):
    """make_synthetic_planetoid at its defaults, through the port's loader:
    Pubmed's 19,717 nodes, 44,338 citations (88,676 directed edges), 500
    features and 3 classes, 60 / 500 / 1,000 nodes in the folds; the
    batch pads the self loops to 20,480 and the citations to 98,304
    slots, whole 2048-edge rows, so the ranked gate holds, and n_pad
    20,480 is above the dense strategy's limit."""
    root = make_synthetic_planetoid(str(tmp_path / "pubmed"), seed=2)
    task = load(t_cit, root, "pubmed")
    (train,) = task._loaded_data[t_base.DataFold.TRAIN]
    (valid,) = task._loaded_data[t_base.DataFold.VALIDATION]
    (test,) = task.load_eval_data_from_path(root)
    assert train.features.shape == (19717, 500)
    assert [a.shape[0] for a in train.adj_lists] == [19717, 88676]
    assert task.get_metadata()["num_output_classes"] == 3
    assert [int(d.mask.sum()) for d in (train, valid, test)] == [60, 500,
                                                                 1000]
    (batch,) = task.make_minibatch_iterator([train], t_base.DataFold.TRAIN, 1)
    assert batch.graph.n_pad == 20480
    assert batch.graph.flat.rcv_rank.shape[0] == 20480 + 98304
    assert t_layers.ranked_aggregation_ok(batch.graph, "sum")
    assert not t_layers.use_dense_strategy(batch.graph, "sum", "auto")
    assert t_graph.bucket_size(19717) == 20480
