"""Data-, graph- and hybrid-parallel checks across real process boundaries
(counterpart of tf_gnn_samples_tpu/parallel/_multihost_check.py).

`run_multihost_check(N, kind=...)` starts N local processes (ranks) on
the CPU over gloo, or with device "cuda" one a GPU over NCCL, joined at a
file:// rendezvous (or a coordinator HOST:PORT) with a RANK_TIMEOUT-second
timeout, each running `main` here. Kind "dp" (dp_main):

1. one data-parallel train step (rank r steps batch r) against
   ONE process stepping the union of the same batches from the same
   state: the graph-weighted mean loss's gradient, clipped, one update
   (rank 0 computes it; parameters within 1e-4, the JAX check's bar);
   the step's graph-weighted metrics against the ranks' own;
2. the ranks' eval metrics, each and reduced;
3. a short final group: batch N on rank 0, zero-weight clones of it on the
   other ranks (finite, contributing exactly 0), against one process
   stepping batch N alone;
4. more replicas than ranks raises;
5. 3 epochs of num_model_replicas = N with the cache and scan_epochs
   (re-packed every 2: built at epochs 1 and 3, scanned at 2), GNN-FiLM
   with dropout on: every rank steps the same groups in the same order and
   logs the same metrics, and the train loss falls;
6. 2 cached epochs of RGCN (no dropout) over folds packed in several
   shapes, recorded for the JAX package's dp epochs to be held to.

Kind "gp" (gp_main): graph_parallel N on the first TRAIN batch, RGCN and
GNN-FiLM, each with plain SGD (clipping off) and the tuned optimizer: a
gp train step and the gp eval against one process on the whole batch
(rank 0; parameters within 1e-4), then cached gp epochs and a process
group of the wrong size; kind "halo" the same with graph_parallel_halo
(the halo shards and layers). Kind "gp_layers" (gp_layers_main): the seven
families' gp layers on a random graph's uneven partitions, split, merged
and with the gathers held until their wait, their gradients, and the
single-process layers (rank 0); the bare PPI-style gp step. Kind
"halo_layers" (halo_layers_main): the same for the seven families' halo
layers (GP_HALO_LAYERS) and the two bare ones, with every all-to-all's
receive buffer held NaN until its wait, and with an edge planted on a
padded halo slot. Kind "hybrid" (hybrid_main, 4 ranks): dp 2 x gp 2
(make_hybrid_mesh), RGCN and GNN-FiLM, SGD unclipped and tuned, by
all-gather and by halo exchange: one hybrid step, row r stepping batch r
partitioned over its two ranks, against one process stepping the
graph-weighted union of the two batches (rank 0; parameters within 1e-4).

Each rank writes what it saw to OUT/rank<r>.pt (numpy arrays and lists;
tests/test_torch_data_parallel.py and tests/test_torch_graph_parallel*.py
hold them against the JAX package) and prints a MULTIHOST_OK line; the
launcher then holds every rank's weights, metrics and epochs equal to
rank 0's (the kind's agree function).

    python -m tf_gnn_samples_torch.parallel._multihost_check --check 2
    python -m tf_gnn_samples_torch.parallel._multihost_check --check 2 \
        --kind gp
    python -m tf_gnn_samples_torch.parallel._multihost_check --check 4 \
        --kind hybrid    # or --kind halo_layers
    python -m tf_gnn_samples_torch.parallel._multihost_check --check 4 \
        --device cuda [--kind gp]    # four GPUs, NCCL
"""

import argparse
import contextlib
import functools
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VALID = os.path.join(ROOT, "data", "qm9", "valid.jsonl.gz")
# The step checks' model: RGCN (no dropout at its defaults) on the f32
# dense branch at this size, as the JAX package's dp tests run it.
STEP_OVERRIDES = {"hidden_size": 16, "graph_num_layers": 2,
                  "max_nodes_in_batch": 200, "random_seed": 5}
# The epochs' model: GNN-FiLM at its dropout defaults.
EPOCH_OVERRIDES = {"hidden_size": 16, "graph_num_layers": 2,
                   "max_nodes_in_batch": 200, "random_seed": 9,
                   "cache_batches_on_device": True, "scan_epochs": True,
                   "repack_cached_every": 2}
EPOCHS = 3
TRAIN_GRAPHS, VALID_GRAPHS = 60, 20
# Step 6's cached RGCN epochs and the np.random seed they start from.
JAX_EPOCHS, JAX_SEED = 2, 3


def qm9_task(task_mod, base_mod, buckets: Optional[int] = None):
    """A QM9 task (either package's modules) over the first TRAIN_GRAPHS
    and VALID_GRAPHS molecules of the bundled valid fold; `buckets` pins
    batch_spec_buckets (1: one batch shape a fold)."""
    params = task_mod.QM9_Task.default_params()
    if buckets is not None:
        params["batch_spec_buckets"] = buckets
    task = task_mod.QM9_Task(params)
    data = task._QM9_Task__load_data(VALID)
    task._loaded_data = {
        base_mod.DataFold.TRAIN: data[:TRAIN_GRAPHS],
        base_mod.DataFold.VALIDATION: data[TRAIN_GRAPHS:
                                           TRAIN_GRAPHS + VALID_GRAPHS]}
    return task


def model_params(cls, **overrides):
    params = cls.default_params()
    params.update(overrides)
    return params


def step_batches(task, base_mod, count: int):
    """The first `count` batches of the task's train graphs, packed in
    order (as a validation fold is: no shuffle)."""
    batches = list(task.make_minibatch_iterator(
        task._loaded_data[base_mod.DataFold.TRAIN],
        base_mod.DataFold.VALIDATION, STEP_OVERRIDES["max_nodes_in_batch"]))
    assert len(batches) >= count, len(batches)
    return batches[:count]


def union_step(model, batches, weight_first: bool = False):
    """One process stepping the graph-weighted union of `batches`
    (TaskBatches on the model's device), as a data-parallel step over them
    computes it: each batch's loss gradient (dropout from
    model._dropout_gen), weighted by its graph count, summed in batch
    order, over the total count, clipped per tensor, one update at the
    learning rate for the total. Weighting after each backward, not one
    backward of the weighted loss: the fused FiLM kernels round the
    cotangent to bf16, and a cotangent scaled by n_i / n before that
    rounding lands on other bf16 numbers, a difference of form and not of
    arithmetic. With `weight_first` a gradient is scaled by its share
    n_i / n before the sum (the hybrid step's order), else by n_i and the
    sum divided by n: the two round differently in f32. Returns the
    batches' losses."""
    from ..runtime.optimizers import clip_grads_per_tensor

    leaves = model._leaves()
    total = sum(int(b.num_graphs) for b in batches)
    total_t = torch.tensor(float(total), device=leaves[0].device)
    acc, losses = None, []
    for b in batches:
        loss, _ = model._forward(model.model_params_tree, b,
                                 model._dropout_gen)
        grads = torch.autograd.grad(loss, leaves)
        n = float(b.num_graphs)
        flat = torch.cat([g.reshape(-1) for g in grads]) * (
            n / total_t if weight_first else n)
        acc = flat if acc is None else acc + flat
        losses.append(loss.detach().clone())
    flat = acc if weight_first else acc / float(total)
    grads = [g.view_as(p) for g, p in zip(
        flat.split([p.numel() for p in leaves]), leaves)]
    grads = clip_grads_per_tensor(grads, model.params["clamp_gradient_norm"])
    model.opt_state = model._optimizer.update(
        grads, model.opt_state, leaves, model._effective_lr(total))
    return losses


def _weights(model):
    """Copies of the parameters (params_to_jax's arrays share a CPU
    tensor's memory, which later updates overwrite)."""
    from ..runtime.model import params_to_jax

    return {k: v.copy() for k, v in params_to_jax(
        model.model_params_tree).items()}


def _host(metrics):
    return {k: np.asarray(v.detach().cpu()) for k, v in metrics.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--kind", default="dp", choices=sorted(KINDS))
    ap.add_argument("--init", default=None,
                    help="gp, halo, hybrid: a pickle of {model name: "
                         "flatten_params "
                         "weights} to start the step checks from")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False

    from . import multihost

    device = multihost.initialize(args.coordinator, args.num_processes,
                                  args.process_id, device=args.device,
                                  timeout=RANK_TIMEOUT)
    try:
        KINDS[args.kind][0](args, device)
    finally:
        multihost.shutdown()


def dp_main(args, device):
    """The dp check's rank (steps 1-6 above)."""
    from . import data_parallel as dp
    from ..runtime import model as t_model
    from ..tasks import base as t_base
    from ..tasks import qm9 as t_qm9

    rank, nproc = args.process_id, args.num_processes
    out = {}
    cls = t_model.RGCN_Model
    task = qm9_task(t_qm9, t_base, buckets=1)
    params = model_params(cls, num_model_replicas=nproc, **STEP_OVERRIDES)
    batches = step_batches(task, t_base, nproc + 1)

    def fresh():
        model = cls(dict(params), task, "mh", args.out, device=device)
        out.setdefault("init", _weights(model))
        return model

    # 1. one dp step against the union step.
    model = fresh()
    red = dp.dp_train_step(model, t_model.batch_to_device(batches[rank],
                                                          model.device),
                           reduce_metrics=True)
    out["dp_step"] = _weights(model)
    out["dp_step_reduced"] = _host(red)
    out["num_graphs"] = [int(b.num_graphs) for b in batches]
    max_diff = 0.0
    if rank == 0:
        union = fresh()
        union_step(union, [t_model.batch_to_device(b, union.device)
                           for b in batches[:nproc]])
        out["union_step"] = _weights(union)
        max_diff = max(float(np.max(np.abs(out["dp_step"][k]
                                           - out["union_step"][k])))
                       for k in out["union_step"])
        assert max_diff < 1e-4, "dp step diverged: max diff %g" % max_diff

    # 2. eval, each rank's and reduced.
    model = fresh()
    mine = t_model.batch_to_device(batches[rank], model.device)
    out["eval"] = _host(dp.dp_eval_step(model, mine))
    out["eval_reduced"] = _host(dp.dp_eval_step(model, mine,
                                                reduce_metrics=True))

    # 3. a short final group: batch nproc on rank 0, padding elsewhere.
    model = fresh()
    last = batches[nproc]
    pad = last if rank == 0 else dp.empty_like_batch(last)
    pad = t_model.batch_to_device(pad, model.device)
    buf, _ = dp.local_grads(model, pad, None)
    assert bool(torch.isfinite(buf).all()), "a padded rank's buffer"
    if rank:
        assert not bool(buf.any()), "a padding replica contributed"
    dp.dp_train_step(model, pad)
    out["padded_step"] = _weights(model)
    if rank == 0:
        alone = fresh()
        alone.params["num_model_replicas"] = 1
        union_step(alone, [t_model.batch_to_device(last, alone.device)])
        out["alone_step"] = _weights(alone)

    # 4. more replicas than ranks.
    model = fresh()
    model.params["num_model_replicas"] = nproc + 1
    try:
        model._run_epoch("x", task._loaded_data[t_base.DataFold.TRAIN],
                         t_base.DataFold.TRAIN, quiet=True)
    except ValueError as e:
        out["too_many_replicas"] = str(e)
    else:
        raise AssertionError("num_model_replicas %d ran on %d ranks"
                             % (nproc + 1, nproc))

    # 5. cached and scanned dp epochs.
    ecls = t_model.GNN_FiLM_Model
    etask = qm9_task(t_qm9, t_base)
    emodel = ecls(model_params(ecls, num_model_replicas=nproc,
                               **EPOCH_OVERRIDES),
                  etask, "mh", args.out, device=device)
    runs = []
    real = emodel._epoch_result

    def recorded(fold, run, device_metrics, start_time):
        runs.append(list(map(int, run)))
        return real(fold, run, device_metrics, start_time)

    emodel._epoch_result = recorded
    epochs = []
    for _ in range(EPOCHS):
        for fold in (t_base.DataFold.TRAIN, t_base.DataFold.VALIDATION):
            loss, metrics, graphs, *_ = emodel._run_epoch(
                "mh", etask._loaded_data[fold], fold, quiet=True)
            epochs.append({"fold": fold.name, "loss": loss,
                           "graphs": graphs, "order": runs[-1],
                           "losses": [float(m["loss"]) for m in metrics],
                           "steps": emodel.batches_run[fold]})
    out["epochs"] = epochs
    train = [e["loss"] for e in epochs if e["fold"] == "TRAIN"]
    assert train[-1] < train[0], train

    # 6. RGCN (no dropout) over the same folds in several batch shapes,
    # cached, for JAX_EPOCHS epochs from np.random.seed(JAX_SEED): the
    # per-batch losses and the weights the JAX package's _run_epoch_dp
    # is held to.
    jtask = qm9_task(t_qm9, t_base)
    jmodel = cls(model_params(cls, num_model_replicas=nproc,
                              cache_batches_on_device=True,
                              **STEP_OVERRIDES),
                 jtask, "mh", args.out, device=device)
    out["jax_epochs_init"] = _weights(jmodel)
    np.random.seed(JAX_SEED)
    out["jax_epochs"] = []
    for _ in range(JAX_EPOCHS):
        for fold in (t_base.DataFold.TRAIN, t_base.DataFold.VALIDATION):
            loss, metrics, *_ = jmodel._run_epoch(
                "mh", jtask._loaded_data[fold], fold, quiet=True)
            out["jax_epochs"].append(
                (fold.name, loss, [float(m["loss"]) for m in metrics]))
    out["jax_epochs_weights"] = _weights(jmodel)
    torch.save(out, os.path.join(args.out, "rank%d.pt" % rank))
    print("MULTIHOST_OK processes=%d device=%s backend=%s loss=%.6f "
          "max_param_diff=%g epoch_losses=%.5f->%.5f" % (
              nproc, device.type, torch.distributed.get_backend(),
              float(red["loss"]), max_diff, train[0], train[-1]),
          flush=True)


def _dp_agree(ranks) -> None:
    """Every rank's weights after the dp and padded steps, its epochs and
    its recorded RGCN epochs, equal to rank 0's (a reduction that differs
    between ranks fails here; one wrong on every rank fails rank 0's
    union check)."""
    for r, got in enumerate(ranks[1:], 1):
        for key in ("dp_step", "padded_step"):
            for name, v in ranks[0][key].items():
                if not np.array_equal(got[key][name], v):
                    raise AssertionError("rank %d's %s weights %s differ "
                                         "from rank 0's" % (r, key, name))
        for key in ("epochs", "jax_epochs"):
            if got[key] != ranks[0][key]:
                raise AssertionError("rank %d's %s differ from rank 0's"
                                     % (r, key))


# ---- graph parallelism ---------------------------------------------------

# The gp step checks' config on top of each model's class defaults and
# its tuned QM9 file: small, dropout off, the f32 "segment" branch (the
# gp layers are f32, as in the JAX package).
GP_STEP_OVERRIDES = {"hidden_size": 16, "graph_num_layers": 2,
                     "max_nodes_in_batch": 200, "random_seed": 5,
                     "graph_layer_input_dropout_keep_prob": 1.0,
                     "aggregation_strategy": "segment"}
GP_MODELS = ("RGCN", "GNN-FiLM")
# "sgd": plain SGD with clipping off (the update is the gradient);
# "tuned": the tuned QM9 optimizer (RMSProp) with its clipping.
GP_OPTIMIZERS = {"sgd": {"optimizer": "SGD", "clamp_gradient_norm": 1e9},
                 "tuned": {}}
# The cached gp epochs' config: GNN-FiLM with dropout on.
GP_EPOCH_OVERRIDES = {"hidden_size": 16, "graph_num_layers": 2,
                      "max_nodes_in_batch": 200, "random_seed": 9,
                      "cache_batches_on_device": True,
                      "repack_cached_every": 2}
# A rank waits this long (seconds) in a collective before it fails.
RANK_TIMEOUT = 60.0


def gp_model(name, task, device, out_dir, nproc, optimizer="tuned",
             **overrides):
    """The port's `name` at its tuned QM9 config with GP_STEP_OVERRIDES,
    the optimizer variant and `overrides` on top, graph_parallel nproc."""
    import json

    from ..train import HYPERS_DIR
    from ..utils.registry import name_to_model_class

    cls, extra = name_to_model_class(name)
    params = {**cls.default_params(), **extra}
    with open(os.path.join(HYPERS_DIR, "QM9_%s.json" % name)) as f:
        params.update(json.load(f)["model_params"])
    params.update(GP_STEP_OVERRIDES)
    params.update(GP_OPTIMIZERS[optimizer])
    params["graph_parallel"] = nproc
    params.update(overrides)
    return cls(params, task, "gp", out_dir, device=device)


def gp_main(args, device, halo=False):
    """The gp check's rank: for RGCN and GNN-FiLM, each optimizer variant,
    one gp train step and the gp eval on the first TRAIN batch (this rank
    stepping its partition), against one process stepping the whole
    batch (rank 0; parameters within 1e-4); then cached gp epochs of
    GNN-FiLM with dropout on, and a process group of the wrong size. With
    `halo` (kind "halo") all of it with graph_parallel_halo: GPHaloShards,
    the halo layers."""
    import pickle

    from . import graph_parallel as gp
    from ..runtime import model as t_model
    from ..tasks import base as t_base
    from ..tasks import qm9 as t_qm9

    rank, nproc = args.process_id, args.num_processes
    init = None
    if args.init:
        with open(args.init, "rb") as f:
            init = pickle.load(f)
    task = qm9_task(t_qm9, t_base, buckets=1)
    batch = step_batches(task, t_base, 1)[0]
    dev_batch = t_model.batch_to_device(batch, device)
    partition = gp.partition_task_batch_halo if halo else (
        gp.partition_task_batch)
    parted = partition(batch, nproc, batch.graph.n_pad,
                       gp.batch_edge_budget(batch), parts=[rank])
    (shard,), n_local = parted[0], parted[1]
    shard = gp.shard_to_device(shard, device)
    out = {"num_nodes": int(batch.num_nodes), "n_pad": batch.graph.n_pad,
           "n_local": n_local, "steps": {},
           "halo_pad": parted[3] if halo else None}
    max_diff = 0.0
    for name in GP_MODELS:
        for opt in GP_OPTIMIZERS:
            model = gp_model(name, task, device, args.out, nproc, opt,
                             graph_parallel_halo=halo)
            if init is not None:
                model.load_weights(init[name])
            rec = {"init": _weights(model)}
            steps = gp.make_gp_task_steps(model)
            rec["eval"] = _host(steps.eval(dev_batch, shard))
            rec["train_metrics"] = _host(steps.train(dev_batch, shard))
            rec["train"] = _weights(model)
            if rank == 0:
                single = gp_model(name, task, device, args.out, nproc, opt,
                                  graph_parallel=1)
                single.load_weights(rec["init"])
                rec["single_eval"] = _host(single._eval_step(dev_batch))
                single._train_step_body(dev_batch)
                rec["single_train"] = _weights(single)
                diff = max(float(np.max(np.abs(rec["train"][k]
                                               - rec["single_train"][k])))
                           for k in rec["train"])
                assert diff < 1e-4, "%s %s gp step diverged: max diff %g" % (
                    name, opt, diff)
                max_diff = max(max_diff, diff)
            out["steps"]["%s %s" % (name, opt)] = rec

    # Cached gp epochs: GNN-FiLM with dropout on, the cache re-packed every
    # 2 epochs (TRAIN packed at 1 and 3, cached at 2), every rank's
    # per-batch losses the same.
    etask = qm9_task(t_qm9, t_base)
    emodel = gp_model("GNN-FiLM", etask, device, args.out, nproc,
                      graph_parallel_halo=halo, **GP_EPOCH_OVERRIDES)
    epochs = []
    for _ in range(EPOCHS):
        for fold in (t_base.DataFold.TRAIN, t_base.DataFold.VALIDATION):
            loss, metrics, graphs, *_ = emodel._run_epoch(
                "gp", etask._loaded_data[fold], fold, quiet=True)
            epochs.append({"fold": fold.name, "loss": loss, "graphs": graphs,
                           "losses": [float(m["loss"]) for m in metrics],
                           "cached": fold in emodel._gp_batch_cache})
    out["epochs"] = epochs
    out["epoch_weights"] = _weights(emodel)

    # A process group of another size than graph_parallel.
    emodel.params["graph_parallel"] = nproc + 1
    try:
        emodel._run_epoch("x", etask._loaded_data[t_base.DataFold.TRAIN],
                          t_base.DataFold.TRAIN, quiet=True)
    except ValueError as e:
        out["wrong_size"] = str(e)
    else:
        raise AssertionError("graph_parallel %d ran on %d ranks"
                             % (nproc + 1, nproc))
    torch.save(out, os.path.join(args.out, "rank%d.pt" % rank))
    train = [e["loss"] for e in epochs if e["fold"] == "TRAIN"]
    print("MULTIHOST_OK processes=%d device=%s backend=%s kind=%s "
          "max_param_diff=%g epoch_losses=%.5f->%.5f" % (
              nproc, device.type, torch.distributed.get_backend(),
              "halo" if halo else "gp", max_diff, train[0], train[-1]),
          flush=True)


def _gp_agree(ranks) -> None:
    """Every rank's weights after each gp step and after the epochs, its
    metrics and its epochs, equal to rank 0's."""
    for r, got in enumerate(ranks[1:], 1):
        for case, rec in ranks[0]["steps"].items():
            for key in ("train", "eval", "train_metrics"):
                for name, v in rec[key].items():
                    if not np.array_equal(got["steps"][case][key][name], v):
                        raise AssertionError("rank %d's %s %s %s differ "
                                             "from rank 0's" % (r, case, key,
                                                                name))
        for name, v in ranks[0]["epoch_weights"].items():
            if not np.array_equal(got["epoch_weights"][name], v):
                raise AssertionError("rank %d's epoch weights %s differ from "
                                     "rank 0's" % (r, name))
        if got["epochs"] != ranks[0]["epochs"]:
            raise AssertionError("rank %d's gp epochs differ from rank 0's"
                                 % r)


def random_typed_graph(n, L=3, seed=0, feat_dim=16):
    """tests/test_graph_parallel.py's random typed graph: L types of
    n..3n random (sender, receiver) pairs, [n, feat_dim] features."""
    rng = np.random.RandomState(seed)
    adj = []
    for _ in range(L):
        e = rng.randint(n, 3 * n)
        adj.append(rng.randint(0, n, size=(e, 2)).astype(np.int32))
    feats = rng.randn(n, feat_dim).astype(np.float32)
    return feats, adj


# The layer checks' graph: 90 nodes over 4 ranks (24 a partition, the last
# holding 18), so the partitions are uneven.
GP_LAYER_NODES = 90
# (case, layer, init kwargs, apply kwargs): tests/test_graph_parallel.py's
# cases, and RGCN's.
GP_LAYER_CASES = (
    ("rgcn", "rgcn", {}, dict(activation_function="relu")),
    ("ggnn", "ggnn", {}, dict(gated_unit_type="gru",
                              activation_function="tanh")),
    ("rgat", "rgat", dict(num_heads=4),
     dict(num_heads=4, activation_function="tanh")),
    ("gnn_film", "gnn_film", {}, dict(activation_function="relu")),
    ("rgin", "rgin", dict(use_target_state_as_input=False,
                          num_edge_MLP_hidden_layers=1),
     dict(activation_function="relu", use_target_state_as_input=False,
          num_edge_MLP_hidden_layers=1)),
    ("rgin target", "rgin", dict(use_target_state_as_input=True,
                                 num_edge_MLP_hidden_layers=1),
     dict(activation_function="relu", use_target_state_as_input=True,
          num_edge_MLP_hidden_layers=1)),
    ("rgin no mlp", "rgin", dict(num_edge_MLP_hidden_layers=None),
     dict(activation_function="relu", num_edge_MLP_hidden_layers=None)),
    ("gnn_edge_mlp", "gnn_edge_mlp",
     dict(use_target_state_as_input=True, num_edge_hidden_layers=1),
     dict(activation_function="gelu", use_target_state_as_input=True,
          num_edge_hidden_layers=1, normalize_by_num_incoming=False)),
    ("gnn_edge_mlp normalize", "gnn_edge_mlp",
     dict(use_target_state_as_input=True, num_edge_hidden_layers=1),
     dict(activation_function="gelu", use_target_state_as_input=True,
          num_edge_hidden_layers=1, normalize_by_num_incoming=True)),
    ("rgdcn", "rgdcn", dict(num_channels=4),
     dict(num_channels=4, activation_function="relu")),
    ("rgdcn full tie", "rgdcn",
     dict(num_channels=4, use_full_state_for_channel_weights=True,
          tie_channel_weights=True),
     dict(num_channels=4, activation_function="relu",
          use_full_state_for_channel_weights=True,
          tie_channel_weights=True)),
    ("rgdcn tie", "rgdcn", dict(num_channels=4, tie_channel_weights=True),
     dict(num_channels=4, activation_function="relu",
          tie_channel_weights=True)),
)


@contextlib.contextmanager
def gathers_held_until_wait():
    """Every asynchronous all_gather_into_tensor leaves its output NaN
    until its wait(), which gathers then: work computed before the wait
    that reads the output comes out NaN."""
    import torch.distributed as dist

    real = dist.all_gather_into_tensor

    class Held:
        def __init__(self, out, src, group):
            self.out, self.src, self.group = out, src, group

        def wait(self):
            with torch.no_grad():
                real(self.out.detach(), self.src, group=self.group)
            return True

    def held(out, x, group=None, async_op=False):
        if not async_op:
            return real(out, x, group=group)
        out.fill_(float("nan"))
        return Held(out, x.detach().clone(), group)

    dist.all_gather_into_tensor = held
    try:
        yield
    finally:
        dist.all_gather_into_tensor = real


def gp_layers_main(args, device):
    """The gp layer checks' rank: each GP_LAYER_CASES layer on this rank's
    partition of a random typed graph (uneven partitions), its output
    all-gathered, and the gradient of sum(output * R) (R fixed, zero past
    the real nodes) for its parameters and its input, summed over the
    ranks; with the source-ownership split (as the runtime runs), over
    the merged stream alone, and with every all-gather's output NaN until
    its wait(). Rank 0 also runs the port's single-process layer on the
    whole graph (the f32 plain branches). Then 5 steps of the bare
    make_gp_train_step (rgcn, PPI-style head)."""
    from . import graph_parallel as gp
    from ..nn.layers import LAYERS
    from ..ops.graph import pad_graph_batch
    from ..ops.graph import graph_to_device
    from ..runtime.model import flatten_params
    from ..runtime.optimizers import Optimizer

    rank, nproc = args.process_id, args.num_processes
    out = {"layers": {}}
    for ci, (case, layer, init_kw, apply_kw) in enumerate(GP_LAYER_CASES):
        feats, adj = random_typed_graph(GP_LAYER_NODES, seed=ci)
        n, d = feats.shape
        L = len(adj)
        params = LAYERS[layer][0](torch.Generator().manual_seed(ci), L, d,
                                  **init_kw)
        params = _unflatten_to(params, device)
        leaves = list(flatten_params(params).values())
        (shard,), n_local, n_global = gp.partition_graph(feats, adj, nproc,
                                                         parts=[rank])
        shard = gp.shard_to_device(shard, device)
        r_full = torch.tensor(np.random.RandomState(100 + ci).randn(
            n_global, d).astype(np.float32), device=device)
        r_full[n:] = 0.0
        r_local = r_full[rank * n_local:(rank + 1) * n_local]
        rec = {"params": {k: v.detach().cpu().numpy()
                          for k, v in flatten_params(params).items()}}

        def run(sh):
            h = shard.node_features.clone().requires_grad_(True)
            o = gp.GP_LAYERS[layer](params, sh, h, None, **apply_kw)
            grads = torch.autograd.grad((o * r_local).sum(), leaves + [h])
            g_par = gp._reduce_grads(list(grads[:-1]), mean=False)
            full = gp.all_gather(o.detach(), 0)[:n]
            g_h = gp.all_gather(grads[-1], 0)[:n]
            return {"out": full.cpu().numpy(),
                    "grads": [g.cpu().numpy() for g in g_par],
                    "grad_h": g_h.cpu().numpy()}

        rec["split"] = run(shard)
        rec["merged"] = run(shard._replace(flat_local=None,
                                           flat_remote=None))
        with gathers_held_until_wait():
            rec["held"] = run(shard)
        if rank == 0:
            graph = graph_to_device(pad_graph_batch(
                feats, adj, np.zeros(n, np.int32), 1, n_pad=128), device)
            h = graph.node_features.clone().requires_grad_(True)
            o = LAYERS[layer][1](params, graph, h,
                                 aggregation_strategy="segment",
                                 typed_edge_scan="unroll", **apply_kw)
            r_pad = torch.zeros_like(o)
            r_pad[:n] = r_full[:n]
            grads = torch.autograd.grad((o * r_pad).sum(), leaves + [h])
            rec["single"] = {"out": o.detach()[:n].cpu().numpy(),
                             "grads": [g.cpu().numpy() for g in grads[:-1]],
                             "grad_h": grads[-1][:n].cpu().numpy()}
        out["layers"][case] = rec

    # The bare PPI-style step: 5 steps of a 2-layer rgcn stack.
    feats, adj = random_typed_graph(120, seed=1)
    (shard,), n_local, n_global = gp.partition_graph(feats, adj, nproc,
                                                     parts=[rank])
    shard = gp.shard_to_device(shard, device)
    labels = torch.tensor((np.random.RandomState(0).rand(n_global, 5) < 0.3)
                          .astype(np.float32), device=device)
    gen = torch.Generator().manual_seed(1)
    params = {"proj": torch.randn(16, 32, generator=gen) * 0.1,
              "layers": [{"W": torch.randn(3, 32, 32, generator=gen) * 0.1}
                         for _ in range(2)],
              "out": torch.randn(32, 5, generator=gen) * 0.1}
    params = _unflatten_to(params, device)
    opt = Optimizer("adam", {})
    opt_state = opt.init(list(flatten_params(params).values()))
    step = gp.make_gp_train_step("rgcn", 2, 5, opt, 1.0)
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(
            params, opt_state, shard,
            labels[rank * n_local:(rank + 1) * n_local], 0.01)
        losses.append(float(loss))
    out["bare_losses"] = losses
    torch.save(out, os.path.join(args.out, "rank%d.pt" % rank))
    print("MULTIHOST_OK processes=%d device=%s backend=%s kind=gp_layers "
          "cases=%d bare_losses=%.5f->%.5f" % (
              nproc, device.type, torch.distributed.get_backend(),
              len(out["layers"]), losses[0], losses[-1]), flush=True)


def _unflatten_to(tree, device):
    """A parameter tree's leaves as f32 leaf tensors on `device` that
    require grad."""
    from ..runtime.model import _unflatten, flatten_params

    return _unflatten({k: v.detach().to(device, torch.float32)
                       .requires_grad_(True)
                       for k, v in flatten_params(tree).items()})


def _gp_layers_agree(ranks) -> None:
    """Every rank's gathered outputs and summed gradients equal to rank
    0's, and its bare-step losses."""
    for r, got in enumerate(ranks[1:], 1):
        for case, rec in ranks[0]["layers"].items():
            for variant in ("split", "merged", "held"):
                want, have = rec[variant], got["layers"][case][variant]
                same = (np.array_equal(have["out"], want["out"])
                        and np.array_equal(have["grad_h"], want["grad_h"])
                        and all(np.array_equal(a, b) for a, b in
                                zip(have["grads"], want["grads"])))
                if not same:
                    raise AssertionError("rank %d's %s layer (%s) differs "
                                         "from rank 0's" % (r, case, variant))
        if got["bare_losses"] != ranks[0]["bare_losses"]:
            raise AssertionError("rank %d's bare-step losses differ from "
                                 "rank 0's" % r)


# ---- the halo exchange and the hybrid step --------------------------------

# (case, layer, init kwargs, apply kwargs): tests/test_graph_parallel.py's
# nine halo cases.
HALO_LAYER_CASES = (
    ("rgcn", "rgcn", {}, dict(activation_function="relu")),
    ("rgcn src and tgt", "rgcn", {"use_both_source_and_target": True},
     dict(activation_function="relu", use_both_source_and_target=True)),
    ("ggnn", "ggnn", {}, dict(gated_unit_type="gru",
                              activation_function="tanh")),
    ("rgat", "rgat", dict(num_heads=4),
     dict(num_heads=4, activation_function="tanh")),
    ("gnn_film", "gnn_film", {}, dict(activation_function="relu")),
    ("rgin target", "rgin", dict(use_target_state_as_input=True,
                                 num_edge_MLP_hidden_layers=1),
     dict(activation_function="relu", use_target_state_as_input=True,
          num_edge_MLP_hidden_layers=1)),
    ("rgin no mlp", "rgin", dict(num_edge_MLP_hidden_layers=None),
     dict(activation_function="relu", num_edge_MLP_hidden_layers=None)),
    ("gnn_edge_mlp normalize", "gnn_edge_mlp",
     dict(use_target_state_as_input=True, num_edge_hidden_layers=1),
     dict(activation_function="gelu", use_target_state_as_input=True,
          num_edge_hidden_layers=1, normalize_by_num_incoming=True)),
    ("rgdcn", "rgdcn", dict(num_channels=4),
     dict(num_channels=4, activation_function="relu")),
)
# The bare layers over the merged src_ext stream, and the single-process
# layer each is held to: (case, layer, its apply kwargs).
HALO_BARE_CASES = (("bare rgcn", "rgcn", dict(activation_function="relu")),
                   ("bare gnn_film", "gnn_film",
                    dict(activation_function="relu")))


def halo_layer_fn(case):
    """(params, shard, h_local, group) -> the case's halo layer output."""
    from . import graph_parallel as gp

    if case == "bare rgcn":
        return lambda p, sh, h, g: gp.gp_halo_rgcn_layer(p["W"], sh, h, g,
                                                         torch.relu)
    if case == "bare gnn_film":
        return lambda p, sh, h, g: gp.gp_film_halo_layer(
            p, sh, h, g, activation_function="relu")
    _, layer, _, apply_kw = next(c for c in HALO_LAYER_CASES if c[0] == case)
    return lambda p, sh, h, g: gp.GP_HALO_LAYERS[layer](p, sh, h, g,
                                                        **apply_kw)


def halo_case_spec(case):
    """(layer, init kwargs, single-process apply kwargs, graph seed)."""
    names = [c[0] for c in HALO_LAYER_CASES + HALO_BARE_CASES]
    for c in HALO_LAYER_CASES:
        if c[0] == case:
            return c[1], c[2], c[3], names.index(case)
    _, layer, apply_kw = next(c for c in HALO_BARE_CASES if c[0] == case)
    return layer, {}, apply_kw, names.index(case)


def plant_padded_slot_edge(shard):
    """The shard with its first real remote edge moved onto a padded slot
    of the same type and source rank (a slot no real edge reads, filled
    from the sender's row 0), or None where the rank has no remote edge or
    that chunk no padded slot."""
    fr = shard.flat_remote
    halo_pad = shard.send_idx.shape[1]
    n_halo = shard.send_idx.shape[0] * halo_pad
    real = np.flatnonzero(fr.mask > 0)
    if not real.size:
        return None
    i = real[0]
    l, slot = divmod(int(fr.src_flat[i]), n_halo)
    chunk = slot // halo_pad
    read = {int(s) % n_halo for s in fr.src_flat[real]}
    free = [c * halo_pad + j for c in [chunk] for j in range(halo_pad)
            if c * halo_pad + j not in read]
    if not free:
        return None
    src = fr.src_flat.copy()
    src[i] = l * n_halo + free[-1]
    return shard._replace(flat_remote=fr._replace(
        src_flat=src,
        perm_by_src=np.argsort(src, kind="stable").astype(np.int32)))


@contextlib.contextmanager
def halo_held_until_wait():
    """Every asynchronous all_to_all_single leaves its output NaN until its
    wait(), which exchanges then: work computed before the wait that
    reads the receive buffer comes out NaN."""
    import torch.distributed as dist

    real = dist.all_to_all_single

    class Held:
        def __init__(self, out, src, group):
            self.out, self.src, self.group = out, src, group

        def wait(self):
            with torch.no_grad():
                real(self.out.detach(), self.src, group=self.group)
            return True

    def held(out, x, *args, group=None, async_op=False, **kwargs):
        if not async_op:
            return real(out, x, *args, group=group, **kwargs)
        out.fill_(float("nan"))
        return Held(out, x.detach().clone(), group)

    dist.all_to_all_single = held
    try:
        yield
    finally:
        dist.all_to_all_single = real


def halo_layers_main(args, device):
    """The halo layer checks' rank: each HALO_LAYER_CASES and
    HALO_BARE_CASES layer on this rank's halo partition of a random typed
    graph (uneven partitions), as gp_layers_main runs the gp layers: its
    output all-gathered and the gradients of sum(output * R) summed over
    the ranks, as it runs ("split"), with every all-to-all's receive
    buffer NaN until its wait ("held"), and ("padded_slot") with this
    rank's first remote edge planted on a padded halo slot; rank 0 also
    the port's single-process layer on the whole graph."""
    from . import graph_parallel as gp
    from ..nn.layers import LAYERS
    from ..ops.graph import graph_to_device, pad_graph_batch
    from ..runtime.model import flatten_params

    rank, nproc = args.process_id, args.num_processes
    out = {"layers": {}}
    for case in [c[0] for c in HALO_LAYER_CASES + HALO_BARE_CASES]:
        layer, init_kw, apply_kw, seed = halo_case_spec(case)
        fn = halo_layer_fn(case)
        feats, adj = random_typed_graph(GP_LAYER_NODES, seed=seed)
        n, d = feats.shape
        params = LAYERS[layer][0](torch.Generator().manual_seed(seed),
                                  len(adj), d, **init_kw)
        params = _unflatten_to(params, device)
        leaves = list(flatten_params(params).values())
        (host_shard,), n_local, n_global, halo_pad = gp.partition_graph_halo(
            feats, adj, nproc, parts=[rank])
        r_full = torch.tensor(np.random.RandomState(100 + seed).randn(
            n_global, d).astype(np.float32), device=device)
        r_full[n:] = 0.0
        r_local = r_full[rank * n_local:(rank + 1) * n_local]
        rec = {"params": {k: v.detach().cpu().numpy()
                          for k, v in flatten_params(params).items()},
               "halo_pad": halo_pad, "n_local": n_local}

        def run(host):
            planted = host is not None
            sh = gp.shard_to_device(host if planted else host_shard, device)
            h = sh.node_features.clone().requires_grad_(True)
            o = fn(params, sh, h, None)
            grads = torch.autograd.grad((o * r_local).sum(), leaves + [h])
            g_par = gp._reduce_grads(list(grads[:-1]), mean=False)
            return {"out": gp.all_gather(o.detach(), 0)[:n].cpu().numpy(),
                    "grads": [g.cpu().numpy() for g in g_par],
                    "grad_h": gp.all_gather(grads[-1], 0)[:n].cpu().numpy(),
                    "planted": planted}

        rec["split"] = run(None)
        with halo_held_until_wait():
            rec["held"] = run(None)
        if case == "rgcn":
            rec["padded_slot"] = run(plant_padded_slot_edge(host_shard))
        if rank == 0:
            graph = graph_to_device(pad_graph_batch(
                feats, adj, np.zeros(n, np.int32), 1, n_pad=128), device)
            h = graph.node_features.clone().requires_grad_(True)
            o = LAYERS[layer][1](params, graph, h,
                                 aggregation_strategy="segment",
                                 typed_edge_scan="unroll", **apply_kw)
            r_pad = torch.zeros_like(o)
            r_pad[:n] = r_full[:n]
            grads = torch.autograd.grad((o * r_pad).sum(), leaves + [h])
            rec["single"] = {"out": o.detach()[:n].cpu().numpy(),
                             "grads": [g.cpu().numpy() for g in grads[:-1]],
                             "grad_h": grads[-1][:n].cpu().numpy()}
        out["layers"][case] = rec
    torch.save(out, os.path.join(args.out, "rank%d.pt" % rank))
    print("MULTIHOST_OK processes=%d device=%s backend=%s kind=halo_layers "
          "cases=%d" % (nproc, device.type, torch.distributed.get_backend(),
                        len(out["layers"])), flush=True)


def _halo_layers_agree(ranks) -> None:
    """Every rank's gathered outputs and summed gradients equal to rank
    0's."""
    for r, got in enumerate(ranks[1:], 1):
        for case, rec in ranks[0]["layers"].items():
            for variant in ("split", "held", "padded_slot"):
                if variant not in rec:
                    continue
                want, have = rec[variant], got["layers"][case][variant]
                same = (np.array_equal(have["out"], want["out"])
                        and np.array_equal(have["grad_h"], want["grad_h"])
                        and all(np.array_equal(a, b) for a, b in
                                zip(have["grads"], want["grads"])))
                if not same:
                    raise AssertionError("rank %d's %s halo layer (%s) "
                                         "differs from rank 0's"
                                         % (r, case, variant))


# The hybrid check's layout: dp rows of gp ranks each.
HYBRID_GP = 2
HYBRID_STRATEGIES = ("allgather", "halo")


def hybrid_main(args, device):
    """The hybrid check's rank: make_hybrid_mesh(gp=2) over the ranks,
    then for RGCN and GNN-FiLM, each optimizer variant and each strategy,
    one hybrid step from one state, row r stepping the r-th batch of the
    train graphs partitioned over its ranks; rank 0 steps the
    graph-weighted union of the rows' batches in one process from the same
    state (union_step; parameters within 1e-4, the loss within 1e-5).
    `args.init`, where given, holds the weights each model starts from."""
    import pickle

    from . import graph_parallel as gp
    from . import multihost
    from ..runtime import model as t_model
    from ..tasks import base as t_base
    from ..tasks import qm9 as t_qm9

    rank, nproc = args.process_id, args.num_processes
    init = None
    if args.init:
        with open(args.init, "rb") as f:
            init = pickle.load(f)
    groups = multihost.make_hybrid_mesh(gp=HYBRID_GP)
    task = qm9_task(t_qm9, t_base, buckets=1)
    batches = step_batches(task, t_base, groups.dp_size)
    mine = batches[groups.row]
    dev_batch = t_model.batch_to_device(mine, device)
    out = {"row": groups.row, "gp_rank": groups.gp_rank,
           "num_graphs": [int(b.num_graphs) for b in batches], "steps": {}}
    shards = {}
    (shards["allgather"],), _, _ = gp.partition_task_batch(
        mine, HYBRID_GP, mine.graph.n_pad, gp.batch_edge_budget(mine),
        parts=[groups.gp_rank])
    (shards["halo"],), _, _, out["halo_pad"] = gp.partition_task_batch_halo(
        mine, HYBRID_GP, mine.graph.n_pad, gp.batch_edge_budget(mine),
        parts=[groups.gp_rank])
    max_diff = 0.0
    for name in GP_MODELS:
        for opt in GP_OPTIMIZERS:
            single = None
            for strategy in HYBRID_STRATEGIES:
                model = gp_model(name, task, device, args.out, HYBRID_GP, opt)
                if init is not None:
                    model.load_weights(init[name])
                rec = {"init": _weights(model)}
                step = multihost.make_hybrid_gp_train_step(model, groups)
                metrics = step(dev_batch, gp.shard_to_device(
                    shards[strategy], device))
                rec["metrics"] = _host(metrics)
                rec["train"] = _weights(model)
                if rank == 0:
                    if single is None:
                        single = gp_model(name, task, device, args.out,
                                          HYBRID_GP, opt, graph_parallel=1)
                        single.load_weights(rec["init"])
                        losses = union_step(single, [
                            t_model.batch_to_device(b, device)
                            for b in batches])
                        n = [float(b.num_graphs) for b in batches]
                        out["union_loss_%s %s" % (name, opt)] = sum(
                            float(x) * c for x, c in zip(losses, n)) / sum(n)
                        rec_union = _weights(single)
                    rec["union"] = rec_union
                    diff = max(float(np.max(np.abs(rec["train"][k]
                                                   - rec_union[k])))
                               for k in rec_union)
                    assert diff < 1e-4, (
                        "hybrid (dp=%d, gp=%d) %s %s %s diverged: max diff %g"
                        % (groups.dp_size, HYBRID_GP, name, opt, strategy,
                           diff))
                    max_diff = max(max_diff, diff)
                out["steps"]["%s %s %s" % (name, opt, strategy)] = rec
    torch.save(out, os.path.join(args.out, "rank%d.pt" % rank))
    print("MULTIHOST_OK processes=%d device=%s backend=%s kind=hybrid "
          "dp=%d gp=%d max_param_diff=%g" % (
              nproc, device.type, torch.distributed.get_backend(),
              groups.dp_size, HYBRID_GP, max_diff), flush=True)


def _hybrid_agree(ranks) -> None:
    """The ranks of each row hold the same weights and metrics bit for
    bit, and every rank rank 0's (the dp sum reaches every rank alike)."""
    for r, got in enumerate(ranks[1:], 1):
        for case, rec in ranks[0]["steps"].items():
            for key in ("train", "metrics"):
                for name, v in rec[key].items():
                    if not np.array_equal(got["steps"][case][key][name], v):
                        raise AssertionError(
                            "rank %d (row %d) %s %s %s differs from rank 0's"
                            % (r, got["row"], case, key, name))


# kind -> (a rank's main, the launcher's check over every rank's record)
KINDS = {"dp": (dp_main, _dp_agree), "gp": (gp_main, _gp_agree),
         "gp_layers": (gp_layers_main, _gp_layers_agree),
         "halo": (functools.partial(gp_main, halo=True), _gp_agree),
         "halo_layers": (halo_layers_main, _halo_layers_agree),
         "hybrid": (hybrid_main, _hybrid_agree)}


def run_multihost_check(num_processes: int = 2, out_dir: Optional[str] = None,
                        coordinator: Optional[str] = None,
                        timeout: float = 300.0, device: str = "cpu",
                        kind: str = "dp", init: Optional[str] = None) -> str:
    """Start `num_processes` local ranks of `main` on `device` (a file://
    rendezvous under `out_dir` unless a `coordinator` HOST:PORT is given)
    running the `kind` check (dp, gp, halo, gp_layers, halo_layers or
    hybrid), wait for them, hold the ranks to each other (the kind's
    agree) and return rank 0's MULTIHOST_OK line; raise on any failure.
    `out_dir` (default: a temporary directory) receives the ranks'
    rank<r>.pt files; `init` (gp, halo, hybrid) the weights the step
    checks start from."""
    out_dir = out_dir or tempfile.mkdtemp(prefix="multihost_check_")
    os.makedirs(out_dir, exist_ok=True)
    if device == "cuda":
        # Once here, not once a rank.
        from ..ops import cuda_build

        cuda_build.build_all()
    coordinator = coordinator or "file://" + os.path.join(out_dir, "store")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    extra = ["--init", init] if init else []
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tf_gnn_samples_torch.parallel."
         "_multihost_check", "--coordinator", coordinator,
         "--num-processes", str(num_processes), "--process-id", str(r),
         "--out", out_dir, "--device", device, "--kind", kind] + extra,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
        text=True) for r in range(num_processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError("multihost check timed out after %.0f s" % timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "MULTIHOST_OK" not in text:
            raise RuntimeError("multihost rank %d failed (rc=%s):\n%s"
                               % (r, p.returncode, text[-4000:]))
    KINDS[kind][1]([torch.load(os.path.join(out_dir, "rank%d.pt" % r),
                               weights_only=False)
                    for r in range(num_processes)])
    return [ln for ln in outs[0].splitlines() if "MULTIHOST_OK" in ln][-1]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--check"]:
        cli = argparse.ArgumentParser()
        cli.add_argument("--check", type=int, nargs="?", const=2)
        cli.add_argument("--device", default="cpu")
        cli.add_argument("--out", default=None)
        cli.add_argument("--kind", default="dp", choices=sorted(KINDS))
        cli_args = cli.parse_args()
        print(run_multihost_check(cli_args.check, out_dir=cli_args.out,
                                  device=cli_args.device,
                                  kind=cli_args.kind))
    else:
        main()
