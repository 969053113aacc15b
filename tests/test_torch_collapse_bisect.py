"""Bisection of the collapsed QM9 seeds: the port's training against the
JAX package's along a real trajectory, on the CPU.

1. Teacher-forced steps. GNN-FiLM and RGCN at their tuned QM9 optimizer
   settings (RMSProp, the tuned learning rate, momentum 0.85, decay 0.98,
   per-tensor clipping at 1.0) cut to hidden 32 and 3 layers, dropout
   off, on 30 real ~600-node packs of data/qm9/train.jsonl.gz. The JAX
   package takes 30 steps and records its parameters and RMSProp slots
   after each; at every step i the port is loaded with JAX's state i
   (params_from_jax, opt_state_from_jax), takes one step on the same
   batch, and is held to JAX's state i + 1. Both packages take the same
   branch: "auto" (GNN-FiLM's fused bf16 FiLM pass, the JAX Pallas
   kernels in interpret mode; RGCN's dense adjacency matmuls at this
   size) and RGCN's ranked one ("pallas": K5 on the card).
2. The schedule over 6 epochs: the learning rate each step gets, the
   order in which the packs are drawn for a seed, and the epochs at which
   the device cache re-packs (cache_batches_on_device, repack_cached_every
   4), read from the two packages' iterators and epoch drivers without
   training.
3. The initial state in distribution (slow): the tuned full-width models
   (hidden 128, 8 layers) on the first valid batch of 50,000-node packing
   (the whole 1,000-graph valid fold), seeds 0-7
   of each package: the initial loss, the mean gate of the gated
   regression head and each layer's output norm. The packages draw from
   different generators, so only the distributions can match.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
STEPS = 30
MODELS = {"GNN-FiLM": (j_model.GNN_FiLM_Model, t_model.GNN_FiLM_Model),
          "RGCN": (j_model.RGCN_Model, t_model.RGCN_Model)}


def tuned_params(model, **extra):
    """The class defaults under the tuned QM9_<model>.json, dropout off."""
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "QM9_%s.json" % model)) as f:
        hypers = json.load(f)["model_params"]
    params = MODELS[model][0].default_params()
    params.update(hypers)
    params["graph_layer_input_dropout_keep_prob"] = 1.0
    params.update(extra)
    return params


def load_task(mod, count):
    task = mod.QM9_Task(mod.QM9_Task.default_params())
    data = task._QM9_Task__load_data(
        os.path.join(ROOT, "data", "qm9", "train.jsonl.gz"))
    return task, data[:count]


@pytest.fixture(scope="module")
def packs():
    """(JAX task, port task, [(JAX batch, port batch)] * STEPS): the first
    STEPS shuffled ~600-node packs of the train file, the two packages'
    iterators run from the same numpy seed."""
    jt, jd = load_task(j_qm9, 1200)
    tt, td = load_task(t_qm9, 1200)
    np.random.seed(0)
    jbs = list(jt.make_minibatch_iterator(jd, j_base.DataFold.TRAIN, 600))
    np.random.seed(0)
    tbs = list(tt.make_minibatch_iterator(td, t_base.DataFold.TRAIN, 600))
    assert len(jbs) == len(tbs) >= STEPS
    return jt, tt, list(zip(jbs, tbs))[:STEPS]


def snapshot(tree):
    """A host copy of a JAX pytree, flattened by name (the train step
    donates its inputs)."""
    return {k: np.array(v, copy=True)
            for k, v in j_model.flatten_params(tree).items()}


def jax_trajectory(jm, batches):
    """JAX's state before each step and after the last: [(params, slots,
    step, loss of the step taken from it)]."""
    step = jm._make_train_step()
    jp, jo = jm.model_params_tree, jm.opt_state
    states = []
    for i, jb in enumerate(batches):
        params, slots = snapshot(jp), snapshot(jo.slots)
        jp, jo, metrics = step(jp, jo, jax.random.PRNGKey(i),
                               jm._device_batch(jb))
        states.append((params, slots, i, float(metrics["loss"])))
    states.append((snapshot(jp), snapshot(jo.slots), int(jo.step), None))
    return states


# (model, aggregation_strategy, bf16 message streams): both packages take
# the same branch. "segment" and RGCN's "auto" (dense adjacency matmuls at
# 600 nodes) are f32 throughout; the JAX package runs them with interpret
# mode off, where its gather VJPs stay f32 too. The bf16 branches (the
# fused FiLM pass, K1-K3; RGCN's ranked segment-sum pair, K5) run the JAX
# Pallas kernels in interpret mode and the port their plain versions.
BRANCHES = [("GNN-FiLM", "segment", False), ("GNN-FiLM", "auto", True),
            ("RGCN", "auto", False), ("RGCN", "pallas", True)]


@pytest.mark.parametrize("model, strategy, bf16", BRANCHES)
def test_teacher_forced_rmsprop_steps_match_jax(packs, tmp_path, monkeypatch,
                                                model, strategy, bf16):
    """At each of 30 steps the port, started from JAX's parameters and
    RMSProp slots, reaches JAX's next parameters and slots on the same
    batch, and computes the same loss.

    Tolerances: tests/test_torch_model.py's for weights and slots (rtol
    1e-5, atol 5e-4), and its loss rtol 1e-5 on the f32 branches
    (measured <= 2.3e-7). On the bf16 branches a streamed value may round
    to the neighbouring bf16 number (2^-8 relative) where the two
    packages' f32 matmul orders differ in a last bit; while the untrained
    model's loss is large (50-140 in the first four steps) that moves it
    by up to 5.3e-5 relative, so the loss is held at 1e-4 there, as
    tests/test_torch_rgat.py holds its bf16 branch. Each tensor's move in
    the step is also held by norm: 1e-4 of the move on the f32 branches
    (measured <= 2.7e-5), 1e-2 on the bf16 ones (<= 9.5e-4)."""
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", bf16)
    jt, tt, batches = packs
    params = tuned_params(model, hidden_size=32, graph_num_layers=3,
                          max_nodes_in_batch=600,
                          aggregation_strategy=strategy)
    assert params["optimizer"] == "RMSProp" and params["momentum"] == 0.85
    jcls, tcls = MODELS[model]
    jm = jcls(dict(params), jt, "j", str(tmp_path))
    tm = tcls(dict(params), tt, "t", str(tmp_path), device="cpu")
    states = jax_trajectory(jm, [jb for jb, _ in batches])
    move_rtol = 1e-2 if bf16 else 1e-4
    for i, (_, tb) in enumerate(batches):
        w, slots, step, jloss = states[i]
        tm.model_params_tree = tm._as_leaves(
            t_model.flatten_params(t_model.params_from_jax(w)))
        tm.opt_state = t_model.opt_state_from_jax(
            slots, step, tm.model_params_tree,
            tm._optimizer.init(tm._leaves()))
        metrics = tm._train_step(t_model.batch_to_device(tb, CPU))
        np.testing.assert_allclose(float(metrics["loss"]), jloss,
                                   rtol=1e-4 if bf16 else 1e-5,
                                   err_msg="step %d" % i)
        w_next, slots_next, step_next, _ = states[i + 1]
        got = t_model.params_to_jax(tm.model_params_tree)
        got_opt = t_model.opt_state_to_jax(tm.opt_state, tm.model_params_tree)
        assert got.keys() == w_next.keys()
        assert got_opt["slots"].keys() == slots_next.keys()
        assert got_opt["step"] == step + 1 == (
            step_next if i + 1 == len(batches) else i + 1)
        # As tests/test_torch_model.py: RMSProp moves a weight by about
        # lr / sqrt(0.02) = 4.7e-3 in its first steps, but an entry whose
        # gradient is near zero takes a step set by the gradient's last
        # digits. 5e-4 is about a tenth of one step.
        for got_t, want_t, before in ((got, w_next, w),
                                      (got_opt["slots"], slots_next, slots)):
            for name in want_t:
                np.testing.assert_allclose(got_t[name], want_t[name],
                                           rtol=1e-5, atol=5e-4,
                                           err_msg="step %d %s" % (i, name))
                move = np.linalg.norm(want_t[name] - before[name])
                off = np.linalg.norm(got_t[name] - want_t[name])
                assert off <= move_rtol * max(move, 1e-30), (i, name, off,
                                                             move)


@pytest.fixture(scope="module")
def full_folds():
    """The bundled train and valid folds, loaded by each package."""
    folds = {}
    for name, mod in (("jax", j_qm9), ("port", t_qm9)):
        task = mod.QM9_Task(mod.QM9_Task.default_params())
        task.load_data(os.path.join(ROOT, "data", "qm9"))
        folds[name] = task
    return folds


def batch_signature(batch):
    """What identifies a pack: its graph count and the bytes of its padded
    node features (equal packs of equal graphs have equal bytes)."""
    feats = np.asarray(batch.graph.node_features, dtype=np.float32)
    return int(batch.num_graphs), hash(feats.tobytes())


@pytest.mark.parametrize("seed", [0, 4])
def test_schedule_over_six_epochs_matches_jax(full_folds, tmp_path, seed):
    """Six epochs at the tuned GNN-FiLM config with the device cache
    re-packed every 4 epochs: the same packs in the same order, packed at
    the same epochs (TRAIN at 1 and 5, VALIDATION at 1), the same learning
    rate and the same step seeds in both packages for a random_seed. The
    learning rate is constant: `learning_rate_decay` (0.98) is RMSProp's
    decay of its mean square in both packages (reference optimizer), not
    a per-epoch decay of the rate."""
    params = tuned_params("GNN-FiLM", hidden_size=8, graph_num_layers=1,
                          random_seed=seed, cache_batches_on_device=True,
                          repack_cached_every=4)
    logs = {}

    def jax_step(params_, opt_state, rng, batch):
        logs["jax"][-1]["packs"].append(batch_signature(batch))
        logs["jax"][-1]["lr"].append(float(jm._effective_lr(
            batch.graph.num_graphs)))
        logs["jax"][-1]["seed"].append(int(np.asarray(rng)[-1]))
        return params_, opt_state, {"loss": np.float32(0)}

    def jax_eval(params_, batch):
        logs["jax"][-1]["packs"].append(batch_signature(batch))
        return {"loss": np.float32(0)}

    def port_step(batch):
        # What _train_step draws before its step: the dropout seed.
        seed_ = int(tm._step_rng.randint(0, 2**31 - 1))
        logs["port"][-1]["packs"].append(batch_signature(batch))
        logs["port"][-1]["lr"].append(float(tm._effective_lr(
            batch.num_graphs)))
        logs["port"][-1]["seed"].append(seed_)
        return {"loss": torch.tensor(0.0)}

    def port_eval(batch):
        logs["port"][-1]["packs"].append(batch_signature(batch))
        return {"loss": torch.tensor(0.0)}

    # Each model seeds the global numpy RNG, which draws the TRAIN
    # shuffles, as it is built: build each just before its epochs.
    for name in ("jax", "port"):
        if name == "jax":
            jm = model = j_model.GNN_FiLM_Model(
                dict(params), full_folds["jax"], "j", str(tmp_path))
            jm._jitted_train_step, jm._jitted_eval_step = jax_step, jax_eval
        else:
            tm = model = t_model.GNN_FiLM_Model(
                dict(params), full_folds["port"], "t", str(tmp_path),
                device="cpu")
            tm._train_step, tm._eval_step = port_step, port_eval
        assert model._optimizer.hparams == {"decay": 0.98, "momentum": 0.85}
        logs[name] = []
        task = model.task
        real_iter = type(task).make_minibatch_iterator
        folds = type(next(iter(task._loaded_data)))

        def counting_iter(data, fold, max_nodes, _log=logs[name],
                          _task=task, _real=real_iter):
            _log[-1]["packed"] += 1
            return _real(_task, data, fold, max_nodes)

        task.make_minibatch_iterator = counting_iter
        try:
            for _ in range(6):
                for fold in (folds.TRAIN, folds.VALIDATION):
                    logs[name].append({"fold": fold.name, "packed": 0,
                                       "packs": [], "lr": [], "seed": []})
                    model._run_epoch("schedule", task._loaded_data[fold],
                                     fold, quiet=True)
        finally:
            del task.make_minibatch_iterator
    assert logs["port"] == logs["jax"]
    train = [e for e in logs["port"] if e["fold"] == "TRAIN"]
    valid = [e for e in logs["port"] if e["fold"] == "VALIDATION"]
    assert [e["packed"] for e in train] == [1, 0, 0, 0, 1, 0]
    assert [e["packed"] for e in valid] == [1, 0, 0, 0, 0, 0]
    assert {lr for e in train for lr in e["lr"]} == {params["learning_rate"]}
    # Cached epochs reshuffle the packs' order; a re-pack makes new packs.
    assert len({tuple(e["packs"]) for e in train}) > 1
    assert set(train[0]["packs"]) == set(train[3]["packs"])
    assert set(train[4]["packs"]) != set(train[0]["packs"])


def initial_state(model, batch, layers_mod, monkeypatch, to_numpy):
    """(loss, mean gate over real nodes, [RMS over real nodes of each
    message-passing layer's output]) of `model`'s untrained forward pass
    on `batch`, no dropout."""
    norms = []
    name = model.layer_name
    init, apply = layers_mod.LAYERS[name]
    mask = to_numpy(batch.graph.node_mask)

    def recording(*args, **kwargs):
        out = apply(*args, **kwargs)
        h = to_numpy(out) * mask[:, None]
        norms.append(float(np.sqrt(np.sum(h * h) / np.sum(mask))))
        return out

    monkeypatch.setitem(layers_mod.LAYERS, name, (init, recording))
    loss, metrics = model._forward(model.model_params_tree, batch, None)
    monkeypatch.setitem(layers_mod.LAYERS, name, (init, apply))
    gate = float(to_numpy(metrics["gate_sum"])) / float(
        to_numpy(metrics["gate_nodes"]))
    return float(to_numpy(loss)), gate, norms


@pytest.mark.slow
@pytest.mark.parametrize("model", ["GNN-FiLM", "RGCN"])
def test_initial_state_distribution_matches_jax(full_folds, tmp_path,
                                                monkeypatch, model):
    """Seeds 0-7 of each package at the tuned full-width config on the
    first valid batch packed under its 50,000-node budget: the initial
    loss, the head's mean gate and each layer's output RMS (GNN-FiLM's
    is sqrt(128) by its unconditional layer norm). For each statistic the
    two packages' means over their eight seeds lie within four standard
    errors of each other (the loss's logs), and seed 0's initial tensors
    have the same spread. Prints the table (PERF.md, Findings)."""
    from tf_gnn_samples_tpu.nn import layers as j_layers
    from tf_gnn_samples_torch.nn import layers as t_layers

    params = tuned_params(model)
    assert params["hidden_size"] == 128 and params["graph_num_layers"] == 8
    jt, tt = full_folds["jax"], full_folds["port"]
    jb = next(jt.make_minibatch_iterator(
        jt._loaded_data[j_base.DataFold.VALIDATION],
        j_base.DataFold.VALIDATION, params["max_nodes_in_batch"]))
    tb = next(tt.make_minibatch_iterator(
        tt._loaded_data[t_base.DataFold.VALIDATION],
        t_base.DataFold.VALIDATION, params["max_nodes_in_batch"]))
    # The whole valid fold: 1,000 graphs, 18,001 nodes in 18,432 rows.
    assert jb.num_graphs == tb.num_graphs == 1000
    assert jb.graph.n_pad == tb.graph.n_pad == 18432
    jcls, tcls = MODELS[model]
    stats = {"jax": [], "port": []}
    for seed in range(8):
        p = dict(params, random_seed=seed)
        jm = jcls(dict(p), jt, "j", str(tmp_path))
        stats["jax"].append(initial_state(
            jm, jm._device_batch(jb), j_layers, monkeypatch, np.asarray))
        tm = tcls(dict(p), tt, "t", str(tmp_path), device="cpu")
        with torch.no_grad():
            stats["port"].append(initial_state(
                tm, t_model.batch_to_device(tb, CPU), t_layers, monkeypatch,
                lambda t: t.detach().cpu().numpy()))
    columns = {}
    for pkg, rows in stats.items():
        columns[pkg] = {"loss": [r[0] for r in rows],
                        "gate": [r[1] for r in rows]}
        for layer in range(params["graph_num_layers"]):
            columns[pkg]["layer %d RMS" % layer] = [r[2][layer] for r in rows]
    print("\n%s, tuned QM9 config, first valid batch (%d graphs), seeds 0-7"
          % (model, tb.num_graphs))
    for key in columns["jax"]:
        for pkg in ("jax", "port"):
            v = np.asarray(columns[pkg][key])
            print("%-12s %-4s min %.4g median %.4g mean %.4g max %.4g | %s"
                  % (key, pkg, v.min(), np.median(v), v.mean(), v.max(),
                     " ".join("%.4g" % x for x in v)))
    for key in columns["jax"]:
        a, b = (np.asarray(columns[pkg][key]) for pkg in ("jax", "port"))
        if key == "loss":  # spread over two decades: compare its log
            a, b = np.log(a), np.log(b)
        spread = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        # Four standard errors: one of the 10 statistics a model would
        # exceed it by chance about once in 1,600 runs.
        assert abs(a.mean() - b.mean()) <= 4 * max(spread, 1e-6 * abs(
            a.mean())), (key, a, b)
    # The draws themselves: every initial tensor of seed 0 of at least
    # 1,000 entries has the same standard deviation within 5 % (the same
    # initializer and fans) and the same sign balance.
    jflat = j_model.flatten_params(jcls(dict(params), jt, "j",
                                        str(tmp_path)).model_params_tree)
    tflat = t_model.params_to_jax(tcls(dict(params), tt, "t", str(tmp_path),
                                       device="cpu").model_params_tree)
    assert jflat.keys() == tflat.keys()
    for name, w in jflat.items():
        w, v = np.asarray(w), tflat[name]
        assert w.shape == v.shape, name
        if w.size >= 1000:
            assert abs(v.std() / w.std() - 1) < 0.05, (name, v.std(), w.std())
            assert abs(v.mean() - w.mean()) < 0.05 * w.std(), name
