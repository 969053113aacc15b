"""The port's runtime around the model: Adam moves its step scalar to the
parameters' device once per update, the epoch loop prefetches batches
on a worker thread (utils/iterators.py ThreadedIterator, queue depth 5)
for the epochs that pack, the device cache keeps a fold's batches once
they are uploaded, and SparseGraphModel keeps the JAX class's
initialize_model() and train() keywords (tests/test_torch_epoch_cache.py
holds the cache, the checkpoints and the writers against the JAX
package)."""

import threading
import time

import numpy as np
import pytest
import torch

from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.runtime import optimizers as t_opt
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9
from tf_gnn_samples_torch.utils.iterators import ThreadedIterator


def test_adam_copies_its_step_scalar_once_per_update(monkeypatch):
    """At most once: Adam's bias correction reads the device step counter
    (OptimizerState.step_t), so an update copies nothing to the device."""
    rng = np.random.RandomState(0)
    params = [torch.from_numpy(rng.randn(4, 3).astype(np.float32))
              for _ in range(7)]
    grads = [torch.from_numpy(rng.randn(4, 3).astype(np.float32))
             for _ in range(7)]
    opt = t_opt.make_optimizer({"optimizer": "Adam"})
    state = opt.init(params)
    calls = []
    to = torch.Tensor.to

    def counted(self, *args, **kwargs):
        calls.append(args)
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", counted)
    state = opt.update(grads, state, params, 1e-3)
    state = opt.update(grads, state, params, 1e-3)
    assert state.step == 2 and len(calls) == 0
    assert float(state.step_t) == 2.0


def test_threaded_iterator_keeps_the_order():
    items = list(range(50))
    with ThreadedIterator(iter(items), max_queue_size=5) as it:
        assert list(it) == items


def test_threaded_iterator_hands_a_worker_exception_to_the_consumer():
    def inner():
        yield 1
        yield 2
        raise ValueError("packing failed")

    it = ThreadedIterator(inner(), max_queue_size=5)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="packing failed"):
        next(it)


def test_threaded_iterator_frees_its_thread_when_abandoned():
    """A consumer that stops after one batch of an endless producer: close()
    lets the worker, blocked on the full queue, end."""
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = threading.active_count()
    with ThreadedIterator(endless(), max_queue_size=2) as it:
        assert next(it) == 0
        worker = it._thread
    worker.join(timeout=5.0)
    assert not worker.is_alive()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def small_model(tmp_path, **extra):
    task = t_qm9.QM9_Task(t_qm9.QM9_Task.default_params())
    data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:40]
    params = t_model.GNN_FiLM_Model.default_params()
    params.update({"hidden_size": 16, "graph_num_layers": 1,
                   "max_nodes_in_batch": 200})
    params.update(extra)
    return t_model.GNN_FiLM_Model(params, task, "t", str(tmp_path),
                                  device="cpu"), data


def test_epochs_prefetch_through_a_threaded_iterator(tmp_path, monkeypatch):
    model, data = small_model(tmp_path)
    made = []
    real = t_model.ThreadedIterator

    def recorded(inner, max_queue_size):
        made.append(max_queue_size)
        return real(inner, max_queue_size=max_queue_size)

    monkeypatch.setattr(t_model, "ThreadedIterator", recorded)
    _, _, graphs, _, _, _ = model._run_epoch(
        "Test", data, t_base.DataFold.VALIDATION, quiet=True)
    assert made == [5] and graphs == 40
    assert model.batches_run[t_base.DataFold.VALIDATION] > 1


@pytest.mark.parametrize("cache", [False, True])
def test_device_cache_key_caches_the_folds(tmp_path, monkeypatch, cache):
    """The key is a default parameter (off). On, the first epoch of a fold
    packs on the prefetch thread and keeps the uploaded batches; later
    epochs run them without a thread. Off, every epoch packs."""
    assert t_model.GNN_FiLM_Model.default_params()[
        "cache_batches_on_device"] is False
    model, data = small_model(tmp_path, cache_batches_on_device=cache)
    made = []
    real = t_model.ThreadedIterator
    monkeypatch.setattr(t_model, "ThreadedIterator",
                        lambda inner, max_queue_size: made.append(1) or real(
                            inner, max_queue_size=max_queue_size))
    for _ in range(3):
        model._run_epoch("Test", data, t_base.DataFold.VALIDATION, quiet=True)
    assert len(made) == (1 if cache else 3)
    assert (t_base.DataFold.VALIDATION in model._batch_cache) == cache
    assert not (tmp_path / "t.log").exists()  # nothing to warn about


def test_initialize_model_and_train_keywords(tmp_path):
    model, data = small_model(tmp_path, max_epochs=1,
                              checkpoint_every_n_epochs=1)
    before = t_model.params_to_jax(model.model_params_tree)
    assert model.initialize_model() is None
    after = t_model.params_to_jax(model.model_params_tree)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    model.task._loaded_data = {t_base.DataFold.TRAIN: data,
                               t_base.DataFold.VALIDATION: data}
    model.train(quiet=True, tf_summary_path=str(tmp_path / "tb"))
    assert (tmp_path / "tb" / "metrics.jsonl").exists()
    model.params["max_epochs"] = 2
    model.train(quiet=True, resume_from=model.training_state_file)
    assert "Resuming from %s at epoch 2." % model.training_state_file in (
        tmp_path / "t.log").read_text()
