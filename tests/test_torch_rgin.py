"""The port's RGIN against the JAX package's, on the CPU: the layer's
ranked branch (the MLP on the node tables, then the fused gather +
segment-sum with its source-order backward; plain versions of K5a here)
against JAX's ranked branch on a graph whose src stream dilutes and
against JAX's unrolled branch on a QM9 pack, the unrolled and bare
branches against JAX's, each with and without the aggregation MLP; and a
2-layer QM9 RGIN model with its weights, checkpoints and CLIs carried
across."""

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

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import edge_ops as j_edge_ops
from tf_gnn_samples_tpu.ops import graph as j_graph
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_tpu.utils import registry as j_registry
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9
from tf_gnn_samples_torch.utils import registry as t_registry

from test_torch_edge_mlp import (KERNEL_GRAD, KERNEL_OUT, SAME_GRAD, SAME_OUT,
                                 compare_layers, count_calls)
from test_torch_edge_mlp_fused import multitype_graph
from test_torch_model import write_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64  # at 64 columns JAX's gather VJPs are ranked kernels, as the port's
CPU = torch.device("cpu")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


@pytest.fixture(scope="module")
def multi():
    """(JAX batch, port batch) of a four-type graph whose fine window is
    compressive (the JAX ranked gate) and whose src stream dilutes."""
    feats, adj, gids = multitype_graph(seed=1)
    e_pads = [-(-a.shape[0] // 2048) * 2048 for a in adj]
    jg = j_graph.pad_graph_batch(feats, adj, gids, 1, e_pads=e_pads)
    tg = t_graph.pad_graph_batch(feats, adj, gids, 1, e_pads=e_pads)
    assert j_layers.compressive_window(jg.flat) and tg.flat.win_sd
    return jg, tg


@pytest.fixture(scope="module")
def qm9():
    """(JAX task, port task, JAX batch, port batch): first 600-node pack."""
    out = []
    for mod, base in ((j_qm9, j_base), (t_qm9, t_base)):
        task = mod.QM9_Task(mod.QM9_Task.default_params())
        data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:200]
        out.append((task, next(task.make_minibatch_iterator(
            data, base.DataFold.VALIDATION, 600))))
    (jt, jb), (tt, tb) = out
    return jt, tt, jb, tb


def layer_inputs(tg, hidden, aggr, target=False, seed=0):
    """RGIN parameters in the JAX package's layout: the stacked edge MLP
    (absent with `hidden` None), the aggregation MLP (with `aggr` hidden
    layers) and the layer norm."""
    rng = np.random.RandomState(seed)
    L = tg.num_edge_types
    params = {"ln": {"scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
                     "bias": (0.1 * rng.randn(D)).astype(np.float32)}}
    if hidden is not None:
        sizes = [2 * D if target else D] + [D] * (hidden + 1)
        params["edge_mlp"] = [
            (rng.randn(L, a, b) / np.sqrt(a)).astype(np.float32)
            for a, b in zip(sizes[:-1], sizes[1:])]
    if aggr is not None:
        params["aggr_mlp"] = {"layers": [
            {"kernel": (rng.randn(D, D) / np.sqrt(D)).astype(np.float32)}
            for _ in range(aggr + 1)]}
    h = rng.randn(tg.n_pad, D).astype(np.float32)
    w = rng.randn(tg.n_pad, D).astype(np.float32)
    return params, h, w


def jax_layer(jg, params, h, w, **cfg):
    weight = jnp.asarray(w) * jg.node_mask[:, None]

    def loss(p, hh):
        out = j_layers.rgin_apply(p, jg, hh, **cfg)
        return jnp.sum(out * weight), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(params, jnp.asarray(h))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def torch_layer(tg, params, h, w, **cfg):
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = t_layers.rgin_apply(tp, tg, th, **cfg)
    (out * torch.from_numpy(w) * tg.node_mask[:, None]).sum().backward()
    grads = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)
    return out.detach().numpy(), (grads, th.grad.numpy())


def branch(tg, **cfg):
    return t_layers.rgin_branch(
        tg, message_aggregation_function=cfg.get(
            "message_aggregation_function", "sum"),
        use_target_state_as_input=cfg.get("use_target_state_as_input", False),
        num_edge_MLP_hidden_layers=cfg.get("num_edge_MLP_hidden_layers", 1),
        typed_edge_scan=cfg.get("typed_edge_scan", "auto"))


@pytest.mark.parametrize("aggr", [None, 1])
def test_ranked_branch_matches_jax_ranked(multi, interpret, monkeypatch,
                                          aggr):
    """Both packages take their ranked branch on this graph: bf16 node
    tables through the fused gather + segment-sum, the diluted src stream
    in the backward. The same bf16 rounding points; the f32 matmuls in
    front of the bf16 cast sum in other orders, so a few table values land
    on the neighbouring bf16 number (the Edge-MLP branches' tolerances)."""
    jg, tg = multi
    cfg = dict(activation_function="elu", num_edge_MLP_hidden_layers=1,
               num_aggr_MLP_hidden_layers=aggr)
    assert branch(tg, **cfg) == "ranked"
    params, h, w = layer_inputs(tg, 1, aggr, seed=2)
    jcalls = count_calls(monkeypatch, j_edge_ops, "_gather_segsum")
    tcalls = count_calls(monkeypatch, t_layers, "gather_aggregate_src")
    want = jax_layer(jg, params, h, w, **cfg)
    got = torch_layer(tg, params, h, w, **cfg)
    assert jcalls and len(tcalls) == 1
    compare_layers(tg, got, want, SAME_OUT, SAME_GRAD)


def test_ranked_branch_matches_jax_unrolled_on_qm9(qm9, interpret):
    """On a QM9 pack the JAX package's gate says no to its ranked branch
    (the fine window is not compressive) and it runs the unrolled f32 one;
    the port runs its ranked branch at every shape. A bf16 table against
    f32 messages: the JAX package's limits between its kernel and unrolled
    branches."""
    _, _, jb, tb = qm9
    jg, tg = jb.graph, tb.graph
    assert not j_layers.compressive_window(jg.flat)
    cfg = dict(activation_function="elu", num_edge_MLP_hidden_layers=1)
    assert branch(tg, **cfg) == "ranked"
    params, h, w = layer_inputs(tg, 1, None, seed=3)
    compare_layers(tg, torch_layer(tg, params, h, w, **cfg),
                   jax_layer(jg, params, h, w, **cfg), KERNEL_OUT,
                   KERNEL_GRAD)


@pytest.mark.parametrize("hidden,target,aggr,aggregation", [
    (1, False, None, "sum"), (2, True, 1, "mean"), (1, True, None, "max"),
    (None, False, None, "sum"), (None, False, 2, "sqrt_n"),
])
def test_unrolled_and_bare_branches_match_jax(multi, hidden, target, aggr,
                                              aggregation):
    """The port's f32 branches against the JAX package's ("unroll" for the
    edge MLP; `num_edge_MLP_hidden_layers` None for the bare one),
    interpret mode off so that JAX's gather VJPs stay f32 segment sums: the
    same f32 arithmetic with other matmul and sum orders (the Edge-MLP
    plain branch's tolerances)."""
    jg, tg = multi
    cfg = dict(activation_function="relu",
               message_aggregation_function=aggregation,
               use_target_state_as_input=target,
               num_edge_MLP_hidden_layers=hidden,
               num_aggr_MLP_hidden_layers=aggr, typed_edge_scan="unroll")
    assert branch(tg, **cfg) == ("bare" if hidden is None else "unrolled")
    params, h, w = layer_inputs(tg, hidden, aggr, target, seed=4)
    compare_layers(tg, torch_layer(tg, params, h, w, **cfg),
                   jax_layer(jg, params, h, w, **cfg),
                   dict(rtol=1e-4, atol=2e-5), dict(rtol=1e-4, atol=1e-3))


def test_branch_gate(multi):
    _, tg = multi
    assert branch(tg) == "ranked"
    assert branch(tg, message_aggregation_function="mean") == "ranked"
    assert branch(tg, message_aggregation_function="max") == "unrolled"
    assert branch(tg, use_target_state_as_input=True) == "unrolled"
    assert branch(tg, typed_edge_scan="unroll") == "unrolled"
    assert branch(tg, num_edge_MLP_hidden_layers=None,
                  typed_edge_scan="scan") == "bare"
    for scan in ("scan", "always"):
        # The per-type scan (ops/typed_stream.py), as the JAX gate takes it.
        assert branch(tg, typed_edge_scan=scan) == "scanned"
    assert t_layers.LAYERS["rgin"] == (t_layers.rgin_init,
                                       t_layers.rgin_apply)


# ---- the model -----------------------------------------------------------------

def small_params(**extra):
    """The tuned QM9 RGIN hypers cut to hidden 64 and 2 layers, dropout
    off (the packages' random streams cannot match)."""
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "QM9_RGIN.json")) as f:
        hypers = json.load(f)["model_params"]
    params = j_model.RGIN_Model.default_params()
    params.update(hypers)
    params.update({"hidden_size": D, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 600})
    params.update(extra)
    return params


def test_hypers_and_defaults_equal_jax():
    name = "QM9_RGIN.json"
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           name), "rb") as f:
        ported = f.read()
    with open(os.path.join(ROOT, "tf_gnn_samples_tpu", "default_hypers",
                           name), "rb") as f:
        assert ported == f.read()
    tdef = t_model.RGIN_Model.default_params()
    jdef = j_model.RGIN_Model.default_params()
    assert tdef == {k: jdef[k] for k in tdef}
    assert tdef["graph_num_aggr_MLP_hidden_layers"] is None


@pytest.mark.parametrize("name", ["RGIN", "rgin", "rgin_model"])
def test_registry_names_equal_jax(name):
    tcls, textra = t_registry.name_to_model_class(name)
    jcls, jextra = j_registry.name_to_model_class(name)
    assert tcls is t_model.RGIN_Model and jcls is j_model.RGIN_Model
    assert textra == jextra == {}
    assert tcls.name(tcls.default_params()) == jcls.name(jcls.default_params())


@pytest.mark.parametrize("aggr", [None, 1])
def test_params_cross_packages(qm9, tmp_path, aggr):
    """params_from_jax / params_to_jax carry RGIN's edge MLP list, its
    aggregation MLP and its layer norm name for name, and the port's model
    has exactly the JAX model's parameter names and shapes."""
    jt, tt, _, _ = qm9
    params = small_params(graph_num_aggr_MLP_hidden_layers=aggr)
    jm = j_model.RGIN_Model(dict(params), jt, "j", str(tmp_path))
    jflat = j_model.flatten_params(jm.model_params_tree)
    tree = t_model.params_from_jax(jflat)
    gnn = tree["prop"]["layers"][1]["gnn"]
    assert [tuple(w.shape) for w in gnn["edge_mlp"]] == [(5, D, D)] * 2
    assert gnn["ln"]["scale"].shape == (D,)
    assert ("aggr_mlp" in gnn) == (aggr is not None)
    if aggr is not None:
        assert [tuple(l["kernel"].shape) for l in gnn["aggr_mlp"]["layers"]
                ] == [(D, D)] * (aggr + 1)
    back = t_model.params_to_jax(tree)
    assert back.keys() == jflat.keys()
    for k in jflat:
        assert np.array_equal(back[k], jflat[k]), k
    tm = t_model.RGIN_Model(dict(params), tt, "t", str(tmp_path), device="cpu")
    tflat = t_model.params_to_jax(tm.model_params_tree)
    assert {k: v.shape for k, v in tflat.items()} == {
        k: np.asarray(v).shape for k, v in jflat.items()}


@pytest.mark.parametrize("scan", ["unroll", "auto"])
def test_model_loss_and_gradient_norms_match_jax(qm9, tmp_path, scan):
    """A 2-layer RGIN on a QM9 pack, weights carried across. The JAX
    package runs its unrolled f32 branch either way (off the TPU, and
    QM9's fine window is not compressive). With "unroll" the port runs its
    f32 branch too: the same arithmetic. With "auto" it runs its ranked
    branch (bf16 node tables), so the two differ as a bf16 stream does
    from an f32 one and are compared by norms: loss and each tensor's
    gradient norm within 2 %, each gradient within 5 % of its norm."""
    jt, tt, jb, tb = qm9
    params = small_params(typed_edge_scan=scan)
    jm = j_model.RGIN_Model(dict(params), jt, "j", str(tmp_path))
    tm = t_model.RGIN_Model(dict(params), tt, "t", str(tmp_path),
                            device="cpu")
    jflat = j_model.flatten_params(jm.model_params_tree)
    tm.load_weights(jflat)
    tloss, _ = tm._forward(tm.model_params_tree,
                           t_model.batch_to_device(tb, CPU), None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    jdev = jm._device_batch(jb)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True)(
            jm.model_params_tree)
    jg = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jg)
    if scan == "unroll":
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   rtol=1e-5)
        for name, g in zip(names, tgrads):
            scale = float(np.abs(jg[name]).max())
            np.testing.assert_allclose(g.numpy(), jg[name], rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)
    else:
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   rtol=2e-2)
        for name, g in zip(names, tgrads):
            norm = float(np.linalg.norm(jg[name]))
            assert abs(float(g.norm()) - norm) <= 2e-2 * norm, name
            assert float(np.linalg.norm(g.numpy() - jg[name])) <= 5e-2 * norm, name


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """A data directory with the first graphs of each bundled QM9 fold."""
    d = tmp_path_factory.mktemp("qm9_small")
    for fold, count in (("train", 300), ("valid", 100), ("test", 150)):
        write_subset(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                     str(d / (fold + ".jsonl.gz")), count)
    return d


def test_checkpoints_cross_packages(qm9, small_data, tmp_path):
    """A JAX-written RGIN pickle loads into the port (the same test loss
    on its f32 branch) and the port's pickle loads back into JAX."""
    jt = qm9[0]
    test_file = str(small_data / "test.jsonl.gz")
    jm = j_model.RGIN_Model(small_params(typed_edge_scan="unroll"), jt, "j",
                            str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))

    def eval_loss(model, base):
        data = model.task.load_eval_data_from_path(test_file)
        return model._run_epoch("Test", data, base.DataFold.TEST,
                                quiet=True)[0]

    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    assert type(tm) is t_model.RGIN_Model
    jloss = eval_loss(jm, j_base)
    np.testing.assert_allclose(eval_loss(tm, t_base), jloss, rtol=1e-5)
    tm.save_model(str(tmp_path / "torch.pickle"))
    with open(tmp_path / "torch.pickle", "rb") as f:
        saved = pickle.load(f)
    assert saved["model_class"] == "RGIN"
    jflat = j_model.flatten_params(jm.model_params_tree)
    assert saved["weights"].keys() == jflat.keys()
    jm2 = j_registry.restore(str(tmp_path / "torch.pickle"), str(tmp_path))
    np.testing.assert_allclose(eval_loss(jm2, j_base), jloss, rtol=1e-6)


def test_train_and_test_clis(small_data, tmp_path):
    """`python -m tf_gnn_samples_torch.train RGIN QM9 --device cpu` takes
    the ranked branch (plain versions on the CPU), writes the log lines the
    bench scripts parse and a checkpoint that the test CLI restores."""
    overrides = json.dumps({"max_epochs": 1, "hidden_size": 16,
                            "graph_num_layers": 2,
                            "max_nodes_in_batch": 2000})
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "RGIN", "QM9",
         "--device", "cpu", "--data-path", str(small_data), "--result-dir",
         str(tmp_path), "--quiet", "--model-param-overrides", overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = r" %s: loss: \d+\.\d{5} \|\| MAEs: 0:\d+\.\d{5} \| Error Ratios: " \
           r"0:\d+\.\d{5} \|\| graphs/sec: \d+\.\d{2} \| nodes/sec: \d+ \| " \
           r"edges/sec: \d+$"
    lines = out.stdout.splitlines()
    assert any(re.match(line % "Train", l) for l in lines), out.stdout
    assert any(re.match(line % "Valid", l) for l in lines), out.stdout
    assert any("QM9_RGIN.json" in l for l in lines), out.stdout
    pickles = list(tmp_path.glob("QM9_RGIN_*_best_model.pickle"))
    assert len(pickles) == 1
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickles[0]),
         str(small_data / "test.jsonl.gz")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^Loss \d+\.\d{5} on 150 graphs$", out.stdout, re.M)
