"""The port's epoch machinery (tf_gnn_samples_torch/runtime/model.py)
against the JAX package's: the device-resident batch cache
(cache_batches_on_device) and its re-pack cadence (repack_cached_every),
the cached dense adjacencies of RGCN's dense strategy, full training-state
checkpoints (checkpoint_every_n_epochs, train(resume_from=)), the
train(tf_summary_path=) writers and the CLI's new flags, all on the CPU
with tiny models (plain versions of the kernels)."""

import glob
import gzip
import itertools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch import train as t_train
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, "data", "qm9", "valid.jsonl.gz")
TRAIN, VALIDATION = t_base.DataFold.TRAIN, t_base.DataFold.VALIDATION


def load(mod, count):
    task = mod.QM9_Task(mod.QM9_Task.default_params())
    return task, task._QM9_Task__load_data(VALID)[:count]


def tiny_model(tmp_path, cls=t_model.RGCN_Model, count=60, **extra):
    """A one-layer, 16-wide model on the first `count` QM9 graphs, with a
    node budget of a few graphs a batch (several batches an epoch); both
    folds hold the same graphs."""
    task, data = load(t_qm9, count)
    task._loaded_data = {TRAIN: data, VALIDATION: data[:20]}
    params = cls.default_params()
    params.update({"hidden_size": 16, "graph_num_layers": 1,
                   "max_nodes_in_batch": 200, "max_epochs": 3,
                   "patience": 100, "random_seed": 13})
    params.update(extra)
    os.makedirs(str(tmp_path), exist_ok=True)
    return cls(params, task, "t", str(tmp_path), device="cpu"), data


def count_packs(monkeypatch, task):
    """Record the fold of every make_minibatch_iterator call."""
    packs = []
    real = task.make_minibatch_iterator

    def counting(data, fold, max_nodes):
        packs.append(fold)
        return real(data, fold, max_nodes)

    monkeypatch.setattr(task, "make_minibatch_iterator", counting)
    return packs


def per_batch(metrics):
    return [{k: np.asarray(v) for k, v in m.items()} for m in metrics]


@pytest.mark.parametrize("cls", [t_model.GNN_FiLM_Model, t_model.RGCN_Model])
def test_cached_validation_fold_gives_the_uncached_metrics(tmp_path, cls,
                                                           monkeypatch):
    """Per-batch metrics of a VALIDATION fold run from the cache equal the
    uncached run's exactly: same batches, same order (RGCN's batches take
    the dense strategy, so the cached run also reads cached adjacencies)."""
    model, data = tiny_model(tmp_path, cls, cache_batches_on_device=True)
    fold = data[:40]
    packs = count_packs(monkeypatch, model.task)
    runs = [model._run_epoch("v", fold, VALIDATION, quiet=True)
            for _ in range(3)]
    assert packs == [VALIDATION]
    assert len(model._batch_cache[VALIDATION]) == len(runs[0][1]) > 1
    uncached = runs[0][1]
    for _, cached, graphs, _, _, _ in runs[1:]:
        assert graphs == 40 and len(cached) == len(uncached)
        for a, b in zip(per_batch(cached), per_batch(uncached)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert [r[0] for r in runs[1:]] == [runs[0][0]] * 2


def test_cached_train_epoch_runs_every_batch_once(tmp_path, monkeypatch):
    """A cached TRAIN epoch steps through each cached batch exactly once,
    in an order drawn by np.random.shuffle from the global numpy RNG
    (GNN-FiLM: no dense adjacency is attached, so the cached batches are
    the uploaded ones)."""
    model, data = tiny_model(tmp_path, t_model.GNN_FiLM_Model,
                             cache_batches_on_device=True)
    stepped = []
    real = model._train_step
    monkeypatch.setattr(model, "_train_step",
                        lambda batch: stepped.append(batch) or real(batch))
    model._run_epoch("t", data, TRAIN, quiet=True)
    cache = model._batch_cache[TRAIN]
    assert [id(b) for b in stepped] == [id(b) for b in cache]
    for _ in range(2):
        stepped.clear()
        np.random.seed(5)
        want = np.arange(len(cache))
        np.random.shuffle(want)
        np.random.seed(5)
        model._run_epoch("t", data, TRAIN, quiet=True)
        assert [id(b) for b in stepped] == [id(cache[i]) for i in want]
    assert model.batches_run[TRAIN] == 3 * len(cache) > 3


def test_repack_cadence_matches_jax(tmp_path, monkeypatch):
    """repack_cached_every 2 over 5 epochs packs TRAIN at epochs 1, 3 and
    5 (tests/test_runtime.py test_repack_cached_every_invalidates_cache),
    in both packages, and both draw the same global numpy stream."""
    extra = dict(cache_batches_on_device=True, repack_cached_every=2,
                 max_epochs=5)
    model, _ = tiny_model(tmp_path / "t", **extra)
    packs = count_packs(monkeypatch, model.task)
    model.train(quiet=True)
    assert [f for f in packs if f == TRAIN] == [TRAIN] * 3
    assert packs == [TRAIN, VALIDATION, TRAIN, TRAIN]
    t_state = np.random.get_state()[1].copy()

    jtask, jdata = load(j_qm9, 60)
    jtask._loaded_data = {j_base.DataFold.TRAIN: jdata,
                          j_base.DataFold.VALIDATION: jdata[:20]}
    params = j_model.RGCN_Model.default_params()
    params.update(model.params)
    os.makedirs(str(tmp_path / "j"))
    jmodel = j_model.RGCN_Model(params, jtask, "j", str(tmp_path / "j"))
    jpacks = count_packs(monkeypatch, jtask)
    jmodel.train(quiet=True)
    assert [f.name for f in jpacks] == [f.name for f in packs]
    np.testing.assert_array_equal(np.random.get_state()[1], t_state)


def test_streamed_fold_is_never_cached(tmp_path):
    class Streamed(list):
        is_streaming = True

    model, data = tiny_model(tmp_path, cache_batches_on_device=True)
    for _ in range(2):
        model._run_epoch("t", Streamed(data), TRAIN, quiet=True)
    assert TRAIN not in model._batch_cache
    log = open(model.log_file).read()
    assert log.count("WARNING: cache_batches_on_device is ignored for a "
                     "streamed data fold") == 1


def test_dense_adjacency_cache_budget_and_release(tmp_path, monkeypatch):
    """RGCN batches of at most 16,384 padded nodes take the dense strategy:
    a cached fold builds each batch's f32 adjacency once, when it is
    cached, counts L * n_pad^2 * 4 bytes a batch against the budget, and
    gives them back when the fold is dropped; over the budget the fold is
    cached without them and every step builds its own."""
    builds = []
    real = t_model.dense_adjacency
    monkeypatch.setattr(t_model, "dense_adjacency",
                        lambda g: builds.append(g.n_pad) or real(g))
    model, data = tiny_model(tmp_path, cache_batches_on_device=True)
    model._run_epoch("v", data, VALIDATION, quiet=True)
    cache = model._batch_cache[VALIDATION]
    n = len(cache)
    assert len(builds) == 2 * n  # n steps, then n attached to the cache
    want_gb = sum(b.graph.num_edge_types * b.graph.n_pad ** 2 * 4 / 1e9
                  for b in cache)
    assert model._dense_adj_cached_gb == pytest.approx(want_gb)
    assert model._fold_adj_gb == {VALIDATION: pytest.approx(want_gb)}
    for b in cache:
        assert b.graph.dense_adj.dtype == torch.float32
        torch.testing.assert_close(b.graph.dense_adj, real(b.graph),
                                   rtol=0, atol=0)
    builds.clear()
    model._run_epoch("v", data, VALIDATION, quiet=True)
    assert builds == []
    model._invalidate_fold_cache(VALIDATION)
    assert model._dense_adj_cached_gb == 0.0 and model._fold_adj_gb == {}

    small, _ = tiny_model(tmp_path / "s", cache_batches_on_device=True,
                          dense_adj_cache_budget_gb=want_gb / 2)
    builds.clear()
    for _ in range(2):
        small._run_epoch("v", data, VALIDATION, quiet=True)
    assert len(builds) == 2 * n  # every step builds its own
    assert all(b.graph.dense_adj is None
               for b in small._batch_cache[VALIDATION])
    assert small._dense_adj_cached_gb == 0.0


def test_full_state_checkpoint_resume(tmp_path):
    """6 epochs straight equal 3 epochs, a checkpoint and 3 resumed epochs
    (tests/test_runtime.py test_full_state_checkpoint_resume: rtol 1e-5;
    here bit for bit), on a tiny RGCN with several shuffled batches an
    epoch and Adam's slots."""
    def make(name, **extra):
        model, _ = tiny_model(tmp_path / name,
                              **dict(dict(max_epochs=6, optimizer="Adam"),
                                     **extra))
        return model

    straight = make("a")
    straight.train(quiet=True)
    first = make("b", max_epochs=3, checkpoint_every_n_epochs=3)
    first.train(quiet=True)
    assert os.path.exists(first.training_state_file)
    resumed = make("c")
    resumed.train(quiet=True, resume_from=first.training_state_file)
    log = open(resumed.log_file).read()
    assert "Resuming from %s at epoch 4." % first.training_state_file in log
    assert log.count("== Epoch") == 3
    a = t_model.params_to_jax(straight.model_params_tree)
    c = t_model.params_to_jax(resumed.model_params_tree)
    assert a.keys() == c.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    assert straight.opt_state.step == resumed.opt_state.step
    for s in straight.opt_state.slots:
        for x, y in zip(straight.opt_state.slots[s], resumed.opt_state.slots[s]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_checkpoint_carries_the_jax_keys_and_names(tmp_path):
    """The port's training-state pickle has the JAX package's keys, its
    weights and optimizer slots the JAX names and shapes, and restores
    bit for bit."""
    model, _ = tiny_model(tmp_path / "t", optimizer="Adam", max_epochs=1,
                          checkpoint_every_n_epochs=1)
    model.train(quiet=True)
    with open(model.training_state_file, "rb") as f:
        t_state = pickle.load(f)

    jtask, _ = load(j_qm9, 60)
    params = j_model.RGCN_Model.default_params()
    params.update(model.params)
    jmodel = j_model.RGCN_Model(params, jtask, "j", str(tmp_path))
    jpath = str(tmp_path / "j.pickle")
    jmodel.save_training_state(jpath, 1, {"best_valid_metric": 1.0})
    with open(jpath, "rb") as f:
        j_state = pickle.load(f)
    assert t_state.keys() == j_state.keys()
    for key in ("weights", "opt_slots"):
        assert ({k: np.shape(v) for k, v in t_state[key].items()}
                == {k: np.shape(v) for k, v in j_state[key].items()}), key
    assert t_state["opt_step"] == model.opt_state.step > 1
    assert t_state["epoch"] == 1

    fresh, _ = tiny_model(tmp_path / "f", optimizer="Adam")
    assert fresh.restore_training_state(model.training_state_file)["epoch"] == 1
    got = t_model.params_to_jax(fresh.model_params_tree)
    for k, v in t_state["weights"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    names = list(t_model.flatten_params(fresh.model_params_tree))
    for slot, ts in fresh.opt_state.slots.items():
        for name, t in zip(names, ts):
            assert not t.requires_grad
            np.testing.assert_array_equal(
                t.numpy(), t_state["opt_slots"]["%s/%s" % (slot, name)])
    assert fresh.opt_state.step == t_state["opt_step"]
    np.testing.assert_array_equal(fresh._step_rng.get_state()[1],
                                  model._step_rng.get_state()[1])


def write_subset(src, dst, count):
    with gzip.open(src, "rt") as fin, gzip.open(dst, "wt") as fout:
        fout.writelines(itertools.islice(fin, count))


def test_cli_cache_checkpoint_resume_tensorboard_profile(tmp_path):
    """The CLI with the cache (re-packed every 2 epochs), a checkpoint a
    epoch, --tensorboard (metrics.jsonl and per-fold event files), then
    --resume of the state file with --profile-dir (a torch.profiler
    trace)."""
    data = tmp_path / "data"
    data.mkdir()
    for fold, count in (("train", 120), ("valid", 40)):
        write_subset(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                     str(data / (fold + ".jsonl.gz")), count)
    out, tb = tmp_path / "out", tmp_path / "tb"
    common = ["GNN-FiLM", "QM9", "--device", "cpu", "--quiet",
              "--data-path", str(data), "--result-dir", str(out)]
    tiny = {"graph_num_layers": 1, "hidden_size": 16,
            "max_nodes_in_batch": 600}
    (model,) = t_train.run(t_train.get_train_args(common + [
        "--tensorboard", str(tb), "--model-param-overrides", json.dumps(dict(
            tiny, max_epochs=2, cache_batches_on_device=True,
            repack_cached_every=2, checkpoint_every_n_epochs=1))]))
    records = [json.loads(line) for line in open(tb / "metrics.jsonl")]
    assert [(r["fold"], r["epoch"]) for r in records] == [
        ("train", 1), ("valid", 1), ("train", 2), ("valid", 2)]
    assert [r["step"] for r in records] == [120, 120, 240, 240]
    for fold in ("train", "valid"):
        assert len(glob.glob(str(tb / ("%s_%s" % (model.run_id, fold))
                                 / "events.out.tfevents.*"))) == 1
    common[-1] = str(tmp_path / "resumed")
    (resumed,) = t_train.run(t_train.get_train_args(common + [
        "--resume", model.training_state_file, "--profile-dir",
        str(tmp_path / "prof"), "--model-param-overrides",
        json.dumps(dict(tiny, max_epochs=3))]))
    log = open(resumed.log_file).read()
    assert "Resuming from %s at epoch 3." % model.training_state_file in log
    assert log.count("== Epoch") == 1
    assert glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
