"""RGAT past the kernels' head caps. K7a and K7b take at most MAX_HEADS
(128) heads and K9 at most RGAT_SRC_MAX_HEADS (96), and the gates in front
of them ask those caps (nn/layers.py rgat_streamed_branch,
ops/ranked_segment.py rgat_fused_supported): past MAX_HEADS the plain
branch runs, past RGAT_SRC_MAX_HEADS the streamed one. The JAX package's
gate has no head term, so at 160 heads it streams where the port takes
the plain branch: the same function, rounded to bf16 at other points.
The port's branch is held here to the JAX package's plain branch under
the same strategy, on the QM9 600-node batch; and a 160-head model trains
through the CLI on the CPU."""

import gzip
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch import train as t_train
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, "data", "qm9", "valid.jsonl.gz")
# The tuned QM9 batch's gate arguments (edges, D, heads, table rows, src
# rows) with a src table shorter than the stream: the fused gate's shape
# term holds, so the head term decides.
DENSE = dict(num_edges=161792, table_rows=51472, src_rows=100000)


@pytest.fixture(scope="module")
def qm9():
    """(JAX batch, port batch): the first 600-node pack of the valid fold."""
    out = []
    for mod, base in ((j_qm9, j_base), (t_qm9, t_base)):
        task = mod.QM9_Task(mod.QM9_Task.default_params())
        data = task._QM9_Task__load_data(VALID)[:200]
        out.append(next(task.make_minibatch_iterator(
            data, base.DataFold.VALIDATION, 600)))
    assert out[1].graph.flat.rcv_rank.shape[0] == 10240
    return out


@pytest.mark.parametrize("heads", [96, 104, 128, 160])
def test_gates_ask_the_head_caps(qm9, heads):
    graph = qm9[1].graph
    dim = heads
    assert t_rs.MAX_HEADS == 128 and t_rs.RGAT_SRC_MAX_HEADS == 96
    assert t_layers.rgat_streamed_branch(graph, dim, heads, "auto") == (
        heads <= 128)
    assert t_rs.rgat_fused_supported(DENSE["num_edges"], dim, heads,
                                     DENSE["table_rows"],
                                     DENSE["src_rows"]) == (heads <= 96)


def test_head_cap_refusal_names_the_cap():
    with pytest.raises(ValueError, match="160 heads, the kernels take 1 to "
                                         "128"):
        t_rs._check_heads("wseg_t", 160, 160)
    with pytest.raises(ValueError, match="16 columns do not split into 3 "
                                         "heads"):
        t_rs._check_heads("wseg_t", 16, 3)


@pytest.mark.parametrize("strategy", ["segment", "auto"])
def test_rgat_160_heads_takes_the_plain_branch_and_matches_jax(
        qm9, monkeypatch, strategy):
    """A 2-timestep RGAT layer with D 160 in 160 heads on the QM9 batch;
    the port takes its plain branch under either strategy (the head-major
    wrappers never run).

    "segment": f32 gathers, softmax and sums on both sides (JAX interpret
    mode off): output and the gradients with respect to W, att and h
    within 1e-5 of each tensor's largest value, as tests/test_torch_rgat.py
    holds the plain branch.

    "auto": the weighted messages are summed through the ranked
    segment-sum's plain version (bf16 terms), held to the JAX plain
    branch, reached by failing its gate's one ranked_aggregation_ok call
    (its aggregation still takes the ranked Pallas kernel, in interpret
    mode). Both sides round the same terms to bf16, but a term whose f32
    bits differ may round to the neighbouring bf16 number (8 of the
    102,400 outputs, measured), so the output is held to the streamed
    branch's tolerances of tests/test_torch_rgat.py: 1e-3 relative norm
    and 2^-8 of its largest value per entry. The gradients are not
    compared there: in interpret mode the JAX side also rounds the
    gathers' cotangents to bf16, which the port keeps in f32 (2.3e-3 to
    2.8e-3 relative norm apart, measured)."""
    auto = strategy == "auto"
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", auto)
    gate_calls = []
    real_ok = j_layers.ranked_aggregation_ok

    def ok(*args, **kwargs):
        gate_calls.append(args)
        return len(gate_calls) > 1 and real_ok(*args, **kwargs)

    monkeypatch.setattr(j_layers, "ranked_aggregation_ok", ok)
    jb, tb = qm9
    dim = heads = 160
    rng = np.random.RandomState(160)
    L = tb.graph.num_edge_types
    params = {"W": (0.1 * rng.randn(L, dim, dim)).astype(np.float32),
              "att": (0.3 * rng.randn(L, 2 * dim)).astype(np.float32)}
    h = rng.randn(tb.graph.n_pad, dim).astype(np.float32)
    w = rng.randn(tb.graph.n_pad, dim).astype(np.float32)
    kw = dict(num_heads=heads, activation_function="elu", num_timesteps=2,
              aggregation_strategy=strategy)
    assert not t_layers.rgat_streamed_branch(tb.graph, dim, heads, strategy)
    calls = []
    for name in ("ranked_weighted_segment_sum_t", "rgat_fused_pass"):
        monkeypatch.setattr(t_rs, name, lambda *a, **k: calls.append(1))

    def loss(p, hh):
        out = j_layers.rgat_apply(p, jb.graph, hh, **kw)
        return jnp.sum(out * w), out

    (_, out), (gp, gh) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(params, h)
    want = [np.asarray(a) for a in (out, gp["W"], gp["att"], gh)]
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = t_layers.rgat_apply(tp, tb.graph, th, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    got = [a.detach().numpy() for a in (out, tp["W"].grad, tp["att"].grad,
                                        th.grad)]
    assert calls == []
    for name, a, b in zip(("out", "dW", "datt", "dh"), got, want):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        scale = float(np.abs(b).max())
        if not auto:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=name)
        elif name == "out":
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel < 1e-3, (name, rel)
            np.testing.assert_allclose(a, b, rtol=0, atol=2 ** -8 * scale,
                                       err_msg=name)


def test_rgat_160_heads_trains_on_the_cpu(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for fold, count in (("train", 200), ("valid", 50)):
        with gzip.open(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                       "rt") as fin, \
                gzip.open(str(data / (fold + ".jsonl.gz")), "wt") as fout:
            fout.writelines(itertools.islice(fin, count))
    (model,) = t_train.run(t_train.get_train_args([
        "RGAT", "QM9", "--device", "cpu", "--quiet", "--data-path",
        str(data), "--result-dir", str(tmp_path), "--model-param-overrides",
        json.dumps({"max_epochs": 1, "graph_num_layers": 1,
                    "hidden_size": 160, "num_heads": 160,
                    "max_nodes_in_batch": 5000})]))
    log = open(model.log_file).read()
    assert np.isfinite(float(log.split(" Train: loss: ")[1].split()[0]))
    assert np.isfinite(float(log.split(" Valid: loss: ")[1].split()[0]))
