"""The port's scanned epochs (scan_epochs over the device cache,
tf_gnn_samples_torch/runtime/model.py _run_epoch_scanned) against the JAX
package's (lax.scan over stacked batches), on the CPU, where the port runs
the same schedule eagerly: the shape groups, the group and batch orders,
the draws from the global numpy RNG and from _step_rng, the per-batch
losses and the weights; a multi-bucket PPI fold's groups; a resumed
scanned run; and the capturable optimizers against the JAX ones."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.runtime import optimizers as j_opt
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import ppi as j_ppi
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.runtime import optimizers as t_opt
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import ppi as t_ppi
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

from fixtures import make_ppi_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, "data", "qm9", "valid.jsonl.gz")
FOLDS = (("TRAIN", 60), ("VALIDATION", 20))
MODELS = {"RGCN": (j_model.RGCN_Model, t_model.RGCN_Model),
          "GNN-FiLM": (j_model.GNN_FiLM_Model, t_model.GNN_FiLM_Model)}


def qm9_task(mod, base):
    task = mod.QM9_Task(mod.QM9_Task.default_params())
    data = task._QM9_Task__load_data(VALID)
    task._loaded_data = {getattr(base.DataFold, f): data[:n]
                         for f, n in FOLDS}
    return task


def tiny_params(cls, **extra):
    """Two layers, 16 wide, dropout off (the packages' random streams
    differ), a few graphs a batch (several batches a fold), the f32
    branches on both sides: RGCN's dense adjacency at this size, GNN-FiLM's
    segment sums (the port's "auto" takes the bf16 fused pass off the
    TPU, the JAX package's does not)."""
    params = cls.default_params()
    params.update({"hidden_size": 16, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 200, "random_seed": 7,
                   "patience": 100, "cache_batches_on_device": True,
                   "scan_epochs": True, "aggregation_strategy": "segment"
                   if cls in (j_model.GNN_FiLM_Model,
                              t_model.GNN_FiLM_Model) else "auto"})
    params.update(extra)
    return params


def run_epochs(model, base, n):
    """n epochs of TRAIN then VALIDATION; per epoch and fold: the
    per-batch losses, the epoch loss and the two RNGs' states after it."""
    out = []
    for _ in range(n):
        for fold, _count in FOLDS:
            f = getattr(base.DataFold, fold)
            loss, metrics, *_ = model._run_epoch(
                "e", model.task._loaded_data[f], f, quiet=True)
            out.append(([float(m["loss"]) for m in metrics], loss,
                        model._step_rng.get_state()[1].copy(),
                        np.random.get_state()[1].copy()))
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_scanned_epochs_match_jax(tmp_path, name):
    """A build epoch and three scanned ones: the same groups, the same
    orders (each per-batch loss list in the order the steps ran), the
    same RNG states after every epoch and fold, and the losses and final
    weights of the f32 branches within tests/test_torch_collapse_bisect.py's
    tolerances (loss rtol 1e-5; weights rtol 1e-5, atol 5e-4)."""
    jcls, tcls = MODELS[name]
    jm = jcls(tiny_params(jcls), qm9_task(j_qm9, j_base), "j", str(tmp_path))
    tm = tcls(tiny_params(tcls), qm9_task(t_qm9, t_base), "t", str(tmp_path),
              device="cpu")
    tm.load_weights(j_model.flatten_params(jm.model_params_tree))
    np.random.seed(3)
    want = run_epochs(jm, j_base, 4)
    np.random.seed(3)
    got = run_epochs(tm, t_base, 4)
    for fold, _ in FOLDS:
        jgroups = [idxs for _, idxs in
                   jm._stacked_cache[getattr(j_base.DataFold, fold)]]
        assert tm._scan_groups[getattr(t_base.DataFold, fold)] == jgroups
    assert len(tm._scan_groups[t_base.DataFold.TRAIN][0]) > 3
    for i, ((tl, te, ts, tn), (jl, je, js, jn)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(ts, js, err_msg="_step_rng %d" % i)
        np.testing.assert_array_equal(tn, jn, err_msg="np.random %d" % i)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg="epoch %d" % i)
        np.testing.assert_allclose(te, je, rtol=1e-5)
    tw = t_model.params_to_jax(tm.model_params_tree)
    jw = j_model.flatten_params(jm.model_params_tree)
    assert tw.keys() == jw.keys()
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=1e-5, atol=5e-4,
                                   err_msg=k)
    assert tm.opt_state.step == int(jm.opt_state.step)
    assert float(tm.opt_state.step_t) == tm.opt_state.step
    n_train = len(got[0][0])
    assert tm.batches_run[t_base.DataFold.TRAIN] == 4 * n_train


def test_ppi_multi_bucket_fold_groups_match_jax(tmp_path):
    """A PPI fold packed into several shapes (tests/test_tasks.py
    test_scanned_epoch_with_multi_spec_fold) gives the JAX package's
    groups, and a scanned epoch runs each batch once."""
    # Five 300-node graphs in 700-node packs: two packs of 640 padded
    # nodes and one of 512.
    root = make_ppi_dir(str(tmp_path / "ppi"),
                        graphs_per_fold={"train": 5, "valid": 1, "test": 1})
    groups = []
    for mod, base in ((j_ppi, j_base), (t_ppi, t_base)):
        task = mod.PPI_Task(mod.PPI_Task.default_params())
        task.load_data(root)
        np.random.seed(0)
        batches = list(task.make_minibatch_iterator(
            task._loaded_data[base.DataFold.TRAIN], base.DataFold.TRAIN,
            700))
        if mod is j_ppi:
            by_key = {}
            for i, b in enumerate(j_model.unify_win_tokens(batches)):
                by_key.setdefault(j_model.batch_shape_key(b), []).append(i)
            groups.append(list(by_key.values()))
        else:
            groups.append(t_model.shape_groups(batches))
    assert groups[0] == groups[1] and len(groups[1]) > 1

    params = tiny_params(t_model.RGCN_Model, max_nodes_in_batch=700)
    task = t_ppi.PPI_Task(t_ppi.PPI_Task.default_params())
    task.load_data(root)
    model = t_model.RGCN_Model(params, task, "t", str(tmp_path), device="cpu")
    data = task._loaded_data[t_base.DataFold.TRAIN]
    np.random.seed(0)
    for _ in range(2):
        _, metrics, *_ = model._run_epoch("e", data, t_base.DataFold.TRAIN,
                                          quiet=True)
    assert model._scan_groups[t_base.DataFold.TRAIN] == groups[1]
    assert len(metrics) == sum(len(g) for g in groups[1])
    assert model.batches_run[t_base.DataFold.TRAIN] == 2 * len(metrics)


def test_scanned_run_resumed_from_epoch_two_ends_where_it_would(tmp_path):
    """4 scanned epochs straight (TRAIN re-packed every 2 epochs: packed at
    epochs 1 and 3, scanned at 2 and 4) equal 2 epochs, a state file and 2
    resumed epochs, whose first re-packs both folds: the weights, slots,
    step and both RNGs bit for bit."""
    def make(name, **extra):
        task = qm9_task(t_qm9, t_base)
        params = tiny_params(t_model.RGCN_Model, **dict(
            dict(optimizer="Adam", repack_cached_every=2, max_epochs=4),
            **extra))
        os.makedirs(str(tmp_path / name))
        return t_model.RGCN_Model(params, task, name, str(tmp_path / name),
                                  device="cpu")

    straight = make("a")
    straight.train(quiet=True)
    first = make("b", max_epochs=2, checkpoint_every_n_epochs=2)
    first.train(quiet=True)
    resumed = make("c")
    resumed.train(quiet=True, resume_from=first.training_state_file)
    assert open(resumed.log_file).read().count("== Epoch") == 2
    a = t_model.params_to_jax(straight.model_params_tree)
    c = t_model.params_to_jax(resumed.model_params_tree)
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    for s in straight.opt_state.slots:
        for x, y in zip(straight.opt_state.slots[s],
                        resumed.opt_state.slots[s]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert straight.opt_state.step == resumed.opt_state.step
    assert float(resumed.opt_state.step_t) == resumed.opt_state.step
    np.testing.assert_array_equal(straight._step_rng.get_state()[1],
                                  resumed._step_rng.get_state()[1])


@pytest.mark.parametrize("name", ["Adam", "RMSProp"])
def test_capturable_optimizers_match_jax_over_five_steps(name, monkeypatch):
    """Five updates from a state restored at step 3 (the device counter set
    from the host step), each reading no host value: no host tensor is
    made and nothing is copied to the parameters' device; the parameters,
    the slots and both step counts equal the JAX optimizer's (one f32
    rounding per op in the same order, tests/test_torch_primitives.py)."""
    rng = np.random.RandomState(11)
    params = [rng.randn(7, 5).astype(np.float32) * s for s in (0.01, 1, 30)]
    hp = {"optimizer": name, "learning_rate_decay": 0.98, "momentum": 0.85}
    j, t = j_opt.make_optimizer(hp), t_opt.make_optimizer(hp)
    jp = [jnp.asarray(p) for p in params]
    js = j.init(jp)
    for _ in range(3):
        jp, js = j.update([jnp.asarray(rng.randn(7, 5).astype(np.float32))
                           for _ in params], js, jp, 1e-3)
    tp = [torch.from_numpy(np.array(p)) for p in jp]
    flat = {"%s/%d" % (k, i): np.asarray(v)
            for k, vs in js.slots.items() for i, v in enumerate(vs)}
    ts = t.init(tp)
    ts = t_opt.OptimizerState(
        step=int(js.step), step_t=t_opt.step_tensor(int(js.step), tp),
        slots={k: [torch.from_numpy(flat["%s/%d" % (k, i)].copy())
                   for i in range(len(vs))] for k, vs in ts.slots.items()})
    made = []
    for fn in ("tensor", "as_tensor"):
        real = getattr(torch, fn)
        monkeypatch.setattr(torch, fn, lambda *a, _r=real, **k:
                            made.append(fn) or _r(*a, **k))
    real_to = torch.Tensor.to
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k:
                        made.append("to") or real_to(self, *a, **k))
    step_t = ts.step_t
    for _ in range(5):
        grads = [rng.randn(7, 5).astype(np.float32) for _ in params]
        jp, js = j.update([jnp.asarray(g) for g in grads], js, jp, 1e-3)
        ts = t.update([torch.from_numpy(g) for g in grads], ts, tp, 1e-3)
    assert made == []
    assert ts.step_t is step_t and float(step_t) == ts.step == int(js.step)
    assert ts.step == 8
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for k, vs in js.slots.items():
        for a, b in zip(ts.slots[k], vs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
