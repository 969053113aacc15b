"""gather_flat_tgt's ranked form (tf_gnn_samples_torch/ops/edge_ops.py
gather_flat_tgt with `ranked`) and the batch's target-sorted view (ops/graph.py
perm_by_tgt, tgt_sorted_rank, tgt_to_rank, win_tgt) against the JAX
package, on the CPU: the view's arrays, the gather's ranked backward
against JAX's _gather_ranked (Pallas kernel in interpret mode), its gate,
and RGCN with use_both_source_and_target, whose target half takes it."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.ops import edge_ops as j_edge_ops
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.ops import edge_ops as t_edge_ops
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
VIEW = ("perm_by_tgt", "tgt_sorted_rank", "tgt_to_rank")

# Both sides sum the same bf16-rounded cotangent terms in f32, in other
# orders (MXU dots over one-hot windows against index_add_): a few f32
# ulps of each row's sum (tests/test_torch_rgcn.py TERMS).
TERMS = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def qm9():
    """(JAX batch, port batch): the first 600-node pack of 200 valid
    graphs (10,240 edges, whole 2,048-edge rows)."""
    out = []
    for mod, base in ((j_qm9, j_base), (t_qm9, t_base)):
        task = mod.QM9_Task(mod.QM9_Task.default_params())
        data = task._QM9_Task__load_data(
            os.path.join(ROOT, "data", "qm9", "valid.jsonl.gz"))[:200]
        out.append((task, next(task.make_minibatch_iterator(
            data, base.DataFold.VALIDATION, 600))))
    (jt, jb), (tt, tb) = out
    assert tb.graph.flat.tgt_flat.shape[0] == 10240
    return jt, tt, jb, tb


def test_target_sorted_view_equals_jax(qm9):
    _, _, jb, tb = qm9
    for name in VIEW:
        got = getattr(tb.graph.flat, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jb.graph.flat, name)),
            err_msg=name)
    assert tb.graph.flat.win_tgt == token_window(jb.graph.flat.win_tgt)
    flat = tb.graph.flat
    tvals = flat.tgt_flat[flat.perm_by_tgt.long()]
    assert bool((tvals[1:] >= tvals[:-1]).all())


@pytest.mark.parametrize("dim", [64, 128])
def test_ranked_backward_matches_jax_gather_ranked(qm9, monkeypatch, dim):
    """gather_flat_tgt (ranked) of an [L * n_pad + 1, dim] table: the
    forward is the clipped take (padded edges read the extra row) and the
    backward sums the bf16 cotangent per tgt rank (K5a's plain version) as
    JAX's _gather_ranked does through its Pallas kernel; rows no edge
    reads get 0."""
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)
    _, _, jb, tb = qm9
    flat, jflat = tb.graph.flat, jb.graph.flat
    rows = tb.graph.num_edge_types * tb.graph.n_pad + 1
    rng = np.random.RandomState(dim)
    table = rng.randn(rows, dim).astype(np.float32)
    g = rng.randn(flat.tgt_flat.shape[0], dim).astype(np.float32)
    assert t_edge_ops.ranked_gather_ok(torch.from_numpy(table), flat,
                                       "tgt_sorted_rank")

    def jfn(t):
        out = j_edge_ops._gather_ranked(
            t, jflat.tgt_flat, jflat.perm_by_tgt, jflat.tgt_sorted_rank,
            jflat.tgt_to_rank, 256, token_window(jflat.win_tgt))
        return jnp.sum(out * g), out

    (_, jout), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(table))
    tt = torch.from_numpy(table.copy()).requires_grad_(True)
    tout = t_edge_ops.gather_flat_tgt(tt, flat, ranked=True)
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), **TERMS)
    unread = flat.tgt_to_rank.numpy() < 0
    assert unread.any() and not tt.grad.numpy()[:-1][unread].any()
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


def test_gate_takes_the_jax_semantic_terms(qm9):
    """At least 64 columns (of a row, however shaped), the view present
    and whole STEP-edge rows; else gather_flat_tgt (index_select's own
    backward)."""
    _, _, _, tb = qm9
    flat = tb.graph.flat
    rows = tb.graph.num_edge_types * tb.graph.n_pad
    ok = t_edge_ops.ranked_gather_ok
    assert ok(torch.zeros(rows, 64), flat, "tgt_sorted_rank")
    assert ok(torch.zeros(rows, 8, 8), flat, "tgt_sorted_rank")
    assert not ok(torch.zeros(rows, 63), flat, "tgt_sorted_rank")
    assert not ok(torch.zeros(rows, 64), flat._replace(tgt_sorted_rank=None),
                  "tgt_sorted_rank")
    cut = flat._replace(src_flat=flat.src_flat[:-1])
    assert not ok(torch.zeros(rows, 64), cut, "tgt_sorted_rank")


def test_rgcn_source_and_target_model_matches_jax(qm9, tmp_path,
                                                  monkeypatch):
    """RGCN at hidden 64 with use_both_source_and_target (neither model
    passes the option to its layer; both are patched to pass it here): the
    loss and every parameter gradient of the 2-layer model. The target
    half's 64-wide gather takes the ranked backward in the port; the JAX
    package takes the same (its gate patched to the port's, the Pallas
    kernels in interpret mode), its aggregation the same ranked K5 pair
    as the port's "auto" at whole rows, and both source gathers stay f32.
    Held as tests/test_torch_rgcn.py holds the ranked model: the loss
    within 1e-4, each gradient within 2e-4 of its norm (a streamed value
    may round to the neighbouring bf16 number where the f32 matmul orders
    differ in a last bit)."""
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)
    gate = j_edge_ops._ranked_gather_ok
    monkeypatch.setattr(
        j_edge_ops, "_ranked_gather_ok",
        lambda table, flat, field: (field == "tgt_sorted_rank"
                                    and gate(table, flat, field)))
    for cls in (j_model.RGCN_Model, t_model.RGCN_Model):
        monkeypatch.setattr(
            cls, "layer_kwargs",
            lambda self, real=cls.layer_kwargs: dict(
                real(self), use_both_source_and_target=True))
    jt, tt, jb, tb = qm9
    params = j_model.RGCN_Model.default_params()
    params.update({"hidden_size": 64, "graph_num_layers": 2,
                   "max_nodes_in_batch": 600, "optimizer": "RMSProp",
                   "use_both_source_and_target": True})
    jm = j_model.RGCN_Model(dict(params), jt, "j", str(tmp_path))
    tm = t_model.RGCN_Model(dict(params), tt, "t", str(tmp_path),
                            device="cpu")
    tm.load_weights(j_model.flatten_params(jm.model_params_tree))
    assert tm.model_params_tree["prop"]["layers"][0]["gnn"]["W"].shape[1] == 128
    jdev = jm._device_batch(jb)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True)(
            jm.model_params_tree)
    tdev = t_model.batch_to_device(tb, CPU)
    calls = []
    real_apply = t_edge_ops._GatherRanked.apply
    monkeypatch.setattr(t_edge_ops._GatherRanked, "apply",
                        lambda *a: calls.append(a[1]) or real_apply(*a))
    tloss, _ = tm._forward(tm.model_params_tree, tdev, None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    # One ranked target gather a layer, none on the source side.
    assert len(calls) == 2 and all(c is tdev.graph.flat.tgt_flat
                                   for c in calls)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-4)
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, tgrads):
        rel = np.linalg.norm(g.numpy() - jflat[name]) / max(
            np.linalg.norm(jflat[name]), 1e-30)
        assert rel < 2e-4, (name, rel)
