"""The port's whole model, checkpoints and CLIs against the JAX package's:
loss, every parameter gradient and two clipped RMSProp steps of GNN-FiLM
on a QM9 batch (hidden 32, 2 layers, max_nodes_in_batch 600, where JAX
takes the fused path); pickles carried across packages; the train/test
CLIs on the CPU; and a subprocess proving the port imports no JAX."""

import gzip
import itertools
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

import run_qm9_benchs
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_tpu.utils import registry as j_registry
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9
from tf_gnn_samples_torch.utils import registry as t_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def small_params(**extra):
    """The tuned QM9 GNN-FiLM hypers cut to hidden 32 and 2 layers, with
    dropout off (the two packages' random streams cannot match)."""
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "QM9_GNN-FiLM.json")) as f:
        hypers = json.load(f)["model_params"]
    params = j_model.GNN_FiLM_Model.default_params()
    params.update(hypers)
    params.update({"hidden_size": 32, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 600})
    params.update(extra)
    return params


def load_task(mod, path, count):
    task = mod.QM9_Task(mod.QM9_Task.default_params())
    return task, task._QM9_Task__load_data(path)[:count]


@pytest.fixture(scope="module")
def qm9():
    """(JAX task, port task, JAX batch, port batch): first 600-node pack."""
    jt, jd = load_task(j_qm9, "data/qm9/valid.jsonl.gz", 200)
    tt, td = load_task(t_qm9, "data/qm9/valid.jsonl.gz", 200)
    jb = next(jt.make_minibatch_iterator(jd, j_base.DataFold.VALIDATION, 600))
    tb = next(tt.make_minibatch_iterator(td, t_base.DataFold.VALIDATION, 600))
    return jt, tt, jb, tb


def test_params_from_jax_roundtrip(qm9, tmp_path):
    jt, _, _, _ = qm9
    jm = j_model.GNN_FiLM_Model(small_params(), jt, "j", str(tmp_path))
    flat = j_model.flatten_params(jm.model_params_tree)
    tree = t_model.params_from_jax(flat)
    assert tree["prop"]["layers"][1]["gnn"]["W_film"].shape == (5, 32, 64)
    back = t_model.params_to_jax(tree)
    assert back.keys() == flat.keys()
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k


def test_model_loss_grads_and_rmsprop_steps_match_jax(qm9, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)
    jt, tt, jb, tb = qm9
    params = small_params()
    jm = j_model.GNN_FiLM_Model(dict(params), jt, "j", str(tmp_path))
    tm = t_model.GNN_FiLM_Model(dict(params), tt, "t", str(tmp_path),
                                device="cpu")
    tm.load_weights(j_model.flatten_params(jm.model_params_tree))
    jdev = jm._device_batch(jb)
    tdev = t_model.batch_to_device(tb, CPU)

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True)(
            jm.model_params_tree)
    tloss, _ = tm._forward(tm.model_params_tree, tdev, None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    # Same bf16 rounding points on both sides, but f32 matmul and sum
    # orders differ, so a few streamed values round to the neighbouring
    # bf16 number (2^-8 relative): entries move by well under 1e-3 of the
    # tensor's largest gradient (measured <= 5e-5).
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, tgrads):
        scale = float(np.abs(jflat[name]).max())
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4,
                                   atol=3e-4 * scale, err_msg=name)

    step = jm._make_train_step()
    jp, jo = jm.model_params_tree, jm.opt_state
    for i in range(2):
        jp, jo, _ = step(jp, jo, jax.random.PRNGKey(i), jdev)
        tm._train_step(tdev)
    assert tm.opt_state.step == int(jo.step) == 2
    jflat = j_model.flatten_params(jp)
    tflat = t_model.params_to_jax(tm.model_params_tree)
    for name in jflat:
        # RMSProp's first steps move a weight by lr * g / sqrt(0.02 g^2 +
        # 1e-10): ~lr / sqrt(0.02) = 4.7e-3 for most entries, but an entry
        # whose gradient is near zero takes a step set by the gradient's
        # last digits, which differ as above (measured <= 1.3e-4). 5e-4 is
        # about a tenth of one step.
        np.testing.assert_allclose(tflat[name], jflat[name], rtol=1e-5,
                                   atol=5e-4, err_msg=name)


def test_remat_layers_gives_the_same_loss_and_grads(qm9, tmp_path):
    """remat_layers recomputes each layer in the backward pass instead of
    keeping its activations: the same numbers."""
    _, tt, _, tb = qm9
    tdev = t_model.batch_to_device(tb, CPU)
    out = []
    for remat in (False, True):
        tm = t_model.GNN_FiLM_Model(small_params(remat_layers=remat), tt,
                                    "t", str(tmp_path), device="cpu")
        loss, _ = tm._forward(tm.model_params_tree, tdev, None)
        out.append([loss] + list(torch.autograd.grad(loss, tm._leaves())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def write_subset(src, dst, count):
    with gzip.open(src, "rt") as fin, gzip.open(dst, "wt") as fout:
        fout.writelines(itertools.islice(fin, count))


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """A data directory with the first graphs of each bundled QM9 fold."""
    d = tmp_path_factory.mktemp("qm9_small")
    for fold, count in (("train", 300), ("valid", 100), ("test", 150)):
        write_subset(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                     str(d / (fold + ".jsonl.gz")), count)
    return d


def eval_loss(model, base, path):
    data = model.task.load_eval_data_from_path(path)
    loss, metrics, graphs, _, _, _ = model._run_epoch(
        "Test", data, base.DataFold.TEST, quiet=True)
    mae = sum(float(m["abs_err_task0"]) for m in metrics) / graphs
    return loss, mae, graphs


def test_checkpoints_cross_packages(qm9, small_data, tmp_path):
    """A JAX pickle loads into the port and gives the same test loss; a
    port pickle carries the same keys and shapes and loads into JAX. Both
    run the plain f32 segment branch (aggregation_strategy from the
    pickle), the JAX package's branch on the CPU."""
    jt, _, _, _ = qm9
    test_file = str(small_data / "test.jsonl.gz")
    jm = j_model.GNN_FiLM_Model(small_params(aggregation_strategy="segment"),
                                jt, "j", str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))
    jloss = eval_loss(jm, j_base, test_file)

    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    tloss = eval_loss(tm, t_base, test_file)
    assert tloss[2] == jloss[2] == 150
    np.testing.assert_allclose(tloss[:2], jloss[:2], rtol=1e-5)

    tm.save_model(str(tmp_path / "torch.pickle"))
    with open(tmp_path / "torch.pickle", "rb") as f:
        saved = pickle.load(f)
    jflat = j_model.flatten_params(jm.model_params_tree)
    assert saved["weights"].keys() == jflat.keys()
    for k, v in saved["weights"].items():
        assert v.shape == jflat[k].shape and v.dtype == np.float32, k
    jm2 = j_registry.restore(str(tmp_path / "torch.pickle"), str(tmp_path))
    np.testing.assert_allclose(eval_loss(jm2, j_base, test_file)[:2],
                               jloss[:2], rtol=1e-5)


def test_train_and_test_clis(small_data, tmp_path):
    """`python -m tf_gnn_samples_torch.train ... --device cpu` writes the log
    lines run_qm9_benchs.py parses (Train/Valid, "Training took", and via
    the test CLI "Metrics:") and a best-model pickle that
    `python -m tf_gnn_samples_torch.test --device cpu` reads."""
    # learning_rate 0 leaves the epoch-2 validation loss equal to epoch
    # 1's, so patience 1 stops training there and logs "Training took".
    overrides = json.dumps({"max_epochs": 3, "patience": 1,
                            "learning_rate": 0.0, "hidden_size": 16,
                            "graph_num_layers": 2,
                            "max_nodes_in_batch": 2000})
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "GNN-FiLM",
         "QM9", "--device", "cpu", "--data-path", str(small_data),
         "--result-dir", str(tmp_path), "--quiet",
         "--model-param-overrides", overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = r" %s: loss: \d+\.\d{5} \|\| MAEs: 0:\d+\.\d{5} \| Error Ratios: " \
           r"0:\d+\.\d{5} \|\| graphs/sec: \d+\.\d{2} \| nodes/sec: \d+ \| " \
           r"edges/sec: \d+$"
    lines = out.stdout.splitlines()
    assert any(re.match(line % "Train", l) for l in lines), out.stdout
    assert any(re.match(line % "Valid", l) for l in lines), out.stdout
    assert "== Epoch 3" not in out.stdout
    assert any(run_qm9_benchs.SCRAPE["train_secs"].match(l)
               for l in lines), out.stdout
    pickles = list(tmp_path.glob("QM9_GNN-FiLM_*_best_model.pickle"))
    assert len(pickles) == 1

    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickles[0]),
         str(small_data / "test.jsonl.gz")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^Loss \d+\.\d{5} on 150 graphs$", out.stdout, re.M)
    assert any(run_qm9_benchs.SCRAPE["mae_ratio"].match(l)
               for l in out.stdout.splitlines()), out.stdout


def test_port_imports_no_jax():
    """Every module of the port (the typed scan, the VarMisuse task and
    its splitter among them), and chip_smoke.py, imports without pulling
    in jax or anything of tf_gnn_samples_tpu."""
    script = (
        "import importlib, pkgutil, sys\n"
        "import tf_gnn_samples_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m.startswith('tf_gnn_samples_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "assert {'tf_gnn_samples_torch.ops.typed_stream', "
        "'tf_gnn_samples_torch.tasks.varmisuse', "
        "'tf_gnn_samples_torch.utils.varmisuse_data_splitter'} <= set(names)\n"
        "print('ok', len(names))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr


def test_device_defaults_to_cuda():
    """Entry points default to CUDA and raise without a GPU rather than
    fall back to the CPU."""
    if torch.cuda.is_available():
        assert t_model.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="No CUDA device"):
            t_model.resolve_device()
    assert t_model.resolve_device("cpu") == CPU


@pytest.mark.parametrize("task, resolves_to", [
    ("PPI", ("PPI", {})),
    ("VarMisuse", ("VarMisuse", {})),
    ("cora", ("CitationNetwork", {"data_kind": "cora"})),
])
def test_unported_names_raise(task, resolves_to):
    # Every model family and every task is ported: each task name resolves
    # as in the JAX package's registry; an unknown name raises.
    cls, extra = t_registry.name_to_task_class(task)
    jcls, jextra = j_registry.name_to_task_class(task)
    assert (cls.name(), extra) == resolves_to == (jcls.name(), jextra)
    with pytest.raises(ValueError):
        t_registry.name_to_task_class("nope")
    with pytest.raises(ValueError):
        t_registry.name_to_model_class("nope")
