"""Data- and graph-parallel checks across real process boundaries
(counterpart of tf_gnn_samples_tpu/parallel/_multihost_check.py, its dp
part and the all-gather gp part; the hybrid dp x gp part waits for the
halo exchange and the hybrid mesh, ROADMAP Queue 1 item 8c).

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
group of the wrong size. Kind "gp_layers" (gp_layers_main): the seven
families' gp layers on a random graph's uneven partitions, split, merged
and with the gathers held until their wait, their gradients, and the
single-process layers (rank 0); the bare PPI-style gp step.

Each rank writes what it saw to OUT/rank<r>.pt (numpy arrays and lists;
tests/test_torch_data_parallel.py and tests/test_torch_graph_parallel*.py
hold them against the JAX package) and prints a MULTIHOST_OK line; the
launcher then holds every rank's weights, metrics and epochs equal to
rank 0's (the kind's agree function).

    python -m tf_gnn_samples_torch.parallel._multihost_check --check 2
    python -m tf_gnn_samples_torch.parallel._multihost_check --check 2 \
        --kind gp
    python -m tf_gnn_samples_torch.parallel._multihost_check --check 4 \
        --device cuda [--kind gp]    # four GPUs, NCCL
"""

import argparse
import contextlib
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


def union_step(model, batches):
    """One process stepping the graph-weighted union of `batches`
    (TaskBatches on the model's device), as a data-parallel step over them
    computes it: each batch's loss gradient (dropout from
    model._dropout_gen), weighted by its graph count, summed in batch
    order, over the total count, clipped per tensor, one update at the
    learning rate for the total. Weighting after each backward, not one
    backward of the weighted loss: the fused FiLM kernels round the
    cotangent to bf16, and a cotangent scaled by n_i / n before that
    rounding lands on other bf16 numbers, a difference of form and not of
    arithmetic. Returns the batches' losses."""
    from ..runtime.optimizers import clip_grads_per_tensor

    leaves = model._leaves()
    total = sum(int(b.num_graphs) for b in batches)
    acc, losses = None, []
    for b in batches:
        loss, _ = model._forward(model.model_params_tree, b,
                                 model._dropout_gen)
        grads = torch.autograd.grad(loss, leaves)
        flat = torch.cat([g.reshape(-1) for g in grads]) * float(b.num_graphs)
        acc = flat if acc is None else acc + flat
        losses.append(loss.detach().clone())
    flat = acc / float(total)
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
                    help="gp: a pickle of {model name: flatten_params "
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


def gp_main(args, device):
    """The gp check's rank: for RGCN and GNN-FiLM, each optimizer variant,
    one gp train step and the gp eval on the first TRAIN batch (this rank
    stepping its partition), against one process stepping the whole
    batch (rank 0; parameters within 1e-4); then cached gp epochs of
    GNN-FiLM with dropout on, and a process group of the wrong size."""
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
    (shard,), n_local, _ = gp.partition_task_batch(
        batch, nproc, batch.graph.n_pad, gp.batch_edge_budget(batch),
        parts=[rank])
    shard = gp.shard_to_device(shard, device)
    out = {"num_nodes": int(batch.num_nodes), "n_pad": batch.graph.n_pad,
           "n_local": n_local, "steps": {}}
    max_diff = 0.0
    for name in GP_MODELS:
        for opt in GP_OPTIMIZERS:
            model = gp_model(name, task, device, args.out, nproc, opt)
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
                      **GP_EPOCH_OVERRIDES)
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
    print("MULTIHOST_OK processes=%d device=%s backend=%s kind=gp "
          "max_param_diff=%g epoch_losses=%.5f->%.5f" % (
              nproc, device.type, torch.distributed.get_backend(), max_diff,
              train[0], train[-1]), flush=True)


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


# kind -> (a rank's main, the launcher's check over every rank's record)
KINDS = {"dp": (dp_main, _dp_agree), "gp": (gp_main, _gp_agree),
         "gp_layers": (gp_layers_main, _gp_layers_agree)}


def run_multihost_check(num_processes: int = 2, out_dir: Optional[str] = None,
                        coordinator: Optional[str] = None,
                        timeout: float = 300.0, device: str = "cpu",
                        kind: str = "dp", init: Optional[str] = None) -> str:
    """Start `num_processes` local ranks of `main` on `device` (a file://
    rendezvous under `out_dir` unless a `coordinator` HOST:PORT is given)
    running the `kind` check (dp, gp or gp_layers), wait for them, hold
    the ranks to each other (the kind's agree) and return rank 0's
    MULTIHOST_OK line; raise on any failure. `out_dir` (default: a
    temporary directory) receives the ranks' rank<r>.pt files; `init`
    (gp) the weights the step checks start from."""
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
