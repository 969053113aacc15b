"""Data-parallel check across real process boundaries (counterpart of
tf_gnn_samples_tpu/parallel/_multihost_check.py, its dp part; the hybrid
dp x gp part waits for graph parallelism).

`run_multihost_check(N)` starts N local processes (ranks) on the CPU over
gloo, or with device "cuda" one a GPU over NCCL, joined at a file://
rendezvous (or a coordinator HOST:PORT), each running `main` here:

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

Each rank writes what it saw to OUT/rank<r>.pt (numpy arrays and lists;
tests/test_torch_data_parallel.py holds them against the JAX package) and
prints a MULTIHOST_OK line; the launcher then holds every rank's weights
after the dp and padded steps, and its epochs, equal to rank 0's.

    python -m tf_gnn_samples_torch.parallel._multihost_check --check 2
    python -m tf_gnn_samples_torch.parallel._multihost_check --check 4 \
        --device cuda    # four GPUs, NCCL
"""

import argparse
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
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False

    from . import data_parallel as dp
    from . import multihost
    from ..runtime import model as t_model
    from ..tasks import base as t_base
    from ..tasks import qm9 as t_qm9

    rank, nproc = args.process_id, args.num_processes
    device = multihost.initialize(args.coordinator, nproc, rank,
                                  device=args.device)
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
    multihost.shutdown()


def _agree(out_dir: str, num_processes: int) -> None:
    """Every rank's weights after the dp and padded steps, its epochs and
    its recorded RGCN epochs, equal to rank 0's (a reduction that differs
    between ranks fails here; one wrong on every rank fails rank 0's
    union check)."""
    ranks = [torch.load(os.path.join(out_dir, "rank%d.pt" % r),
                        weights_only=False) for r in range(num_processes)]
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


def run_multihost_check(num_processes: int = 2, out_dir: Optional[str] = None,
                        coordinator: Optional[str] = None,
                        timeout: float = 300.0, device: str = "cpu") -> str:
    """Start `num_processes` local ranks of `main` on `device` (a file://
    rendezvous under `out_dir` unless a `coordinator` HOST:PORT is given),
    wait for them, hold the ranks to each other (_agree) and return rank
    0's MULTIHOST_OK line; raise on any failure. `out_dir` (default: a
    temporary directory) receives the ranks' rank<r>.pt files."""
    out_dir = out_dir or tempfile.mkdtemp(prefix="multihost_check_")
    if device == "cuda":
        # Once here, not once a rank.
        from ..ops import cuda_build

        cuda_build.build_all()
    coordinator = coordinator or "file://" + os.path.join(out_dir, "store")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tf_gnn_samples_torch.parallel."
         "_multihost_check", "--coordinator", coordinator,
         "--num-processes", str(num_processes), "--process-id", str(r),
         "--out", out_dir, "--device", device],
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
    _agree(out_dir, num_processes)
    return [ln for ln in outs[0].splitlines() if "MULTIHOST_OK" in ln][-1]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--check"]:
        cli = argparse.ArgumentParser()
        cli.add_argument("--check", type=int, nargs="?", const=2)
        cli.add_argument("--device", default="cpu")
        cli.add_argument("--out", default=None)
        cli_args = cli.parse_args()
        print(run_multihost_check(cli_args.check, out_dir=cli_args.out,
                                  device=cli_args.device))
    else:
        main()
