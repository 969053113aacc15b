"""The port's RGCN/GGNN slice against the JAX package's, on a small QM9
batch (max_nodes_in_batch 600: n_pad 640, E 10,240 = 5 * 2048): the
ranked segment-sum / expand pair's plain versions against the Pallas
kernels (interpret mode) and its VJPs, aggregate_flat and the ranked and
dense aggregation paths, the RGCN and GGNN layers under each aggregation
strategy, the 2-layer models (loss, gradients, one RMSProp step),
checkpoints carried across packages and the CLIs on the CPU."""

import gzip
import itertools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import edge_ops as j_edge
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import edge_ops as t_edge
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9
from tf_gnn_samples_torch.utils import registry as t_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
D = 32  # below 64, so the JAX gather VJPs stay f32 XLA segment sums
MODELS = {"RGCN": (j_model.RGCN_Model, t_model.RGCN_Model),
          "GGNN": (j_model.GGNN_Model, t_model.GGNN_Model)}

# Both sides sum the same bf16-rounded terms in f32, only in different
# orders (MXU dots over one-hot windows vs index_add_): a few f32 ulps of
# each row's sum; the dump rank sums ~5,000 terms. The tolerance of the
# JAX kernel tests against their XLA oracle (tests/test_ranked_segment.py).
TERMS = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


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
    assert jb.graph.n_pad == 640 and tb.graph.flat.rcv_rank.shape[0] == 10240
    return jt, tt, jb, tb


def i32(t):
    return jnp.asarray(t.numpy())


def rows_of(tg):
    return t_rs.rank_table_rows(tg.n_pad, 256)


# ---- the K5 pair --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [16, 64])
def test_segsum_plain_matches_pallas(qm9, dtype, dim):
    """K5a's plain version against _segsum_table_impl (interpret): every
    term rounded to bf16, summed in f32, for an f32 and a bf16 stream."""
    _, _, jb, tb = qm9
    tg = tb.graph
    rng = np.random.RandomState(dim)
    m = (3 * rng.randn(tg.flat.rcv_rank.shape[0], dim)).astype(np.float32)
    tm = torch.from_numpy(m).to(getattr(torch, dtype))
    jm = jnp.asarray(m).astype(getattr(jnp, dtype))
    rows = rows_of(tg)
    want = j_rs._segsum_table_impl(
        jm, i32(tg.flat.rcv_rank), table_rows=rows, block_edges=256,
        win=token_window(jb.graph.flat.win_fine))
    got = t_rs._segsum_table_impl(tm, tg.flat.rcv_rank, table_rows=rows)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TERMS)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


@pytest.mark.parametrize("dim", [16, 64])
def test_expand_plain_matches_pallas_exactly(qm9, dim):
    """K5b's plain version against _expand_impl (interpret): each edge gets
    its rank's table row rounded to bf16, exactly."""
    _, _, jb, tb = qm9
    tg = tb.graph
    table = np.random.RandomState(dim + 1).randn(rows_of(tg), dim).astype(
        np.float32)
    want = j_rs._expand_impl(jnp.asarray(table), i32(tg.flat.rcv_rank),
                             block_edges=256,
                             win=token_window(jb.graph.flat.win_fine))
    got = t_rs._expand_impl(torch.from_numpy(table), tg.flat.rcv_rank)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["segsum", "expand"])
def test_ranked_pair_vjps_match_jax(qm9, fn):
    """Forward and VJP of ranked_segment_sum_table / ranked_expand_table
    (each the other's VJP), with the dtype handoff: the segsum VJP comes
    back in the message dtype, the expand VJP in the table dtype."""
    _, _, jb, tb = qm9
    tg = tb.graph
    rng = np.random.RandomState(7)
    e, rows = tg.flat.rcv_rank.shape[0], rows_of(tg)
    win = token_window(jb.graph.flat.win_fine)
    ranks = tg.flat.rcv_rank
    if fn == "segsum":
        x = rng.randn(e, D).astype(np.float32)
        g = rng.randn(rows, D).astype(np.float32)
        jfn = lambda a: j_rs.ranked_segment_sum_table(a, i32(ranks), rows,
                                                      256, win)
        tfn = lambda a: t_rs.ranked_segment_sum_table(a, ranks, rows)
    else:
        x = rng.randn(rows, D).astype(np.float32)
        g = rng.randn(e, D).astype(np.float32)
        jfn = lambda a: j_rs.ranked_expand_table(a, i32(ranks), rows, 256,
                                                 win)
        tfn = lambda a: t_rs.ranked_expand_table(a, ranks, rows)
    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tfn(tx)
    (tdx,) = torch.autograd.grad(tout, tx, torch.from_numpy(g))
    assert tdx.dtype == torch.float32 and tdx.shape == tx.shape
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TERMS)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TERMS)
    # A bf16 stream gets its cotangent back in bf16.
    if fn == "segsum":
        tb16 = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        (d16,) = torch.autograd.grad(tfn(tb16), tb16, torch.from_numpy(g))
        assert d16.dtype == torch.bfloat16


def test_ranked_wrappers_check_shapes_and_gate():
    with pytest.raises(ValueError):
        t_rs._segsum_table_impl(torch.zeros(8, 4), torch.zeros(7, dtype=torch.int32),
                                table_rows=4)
    assert t_rs.ranked_supported(4096)
    assert not t_rs.ranked_supported(4096 + 8)
    assert not t_rs.ranked_supported(0)
    assert t_rs.rank_table_rows(640, 256) == j_rs.rank_table_rows(640, 256)
    assert t_rs.STEP == j_rs.STEP


# ---- aggregation paths --------------------------------------------------

def _messages(tg, seed):
    e = tg.flat.rcv_rank.shape[0]
    return np.random.RandomState(seed).randn(e, D).astype(np.float32)


def _agg_vs_jax(jfn, tfn, msgs, w):
    jval, vjp = jax.vjp(jfn, jnp.asarray(msgs))
    (jgrad,) = vjp(jnp.asarray(w))
    tm = torch.from_numpy(msgs.copy()).requires_grad_(True)
    tval = tfn(tm)
    (tgrad,) = torch.autograd.grad(tval, tm, torch.from_numpy(w))
    return (tval.detach().numpy(), tgrad.numpy()), (np.asarray(jval),
                                                    np.asarray(jgrad))


@pytest.mark.parametrize("aggregation", ["sum", "mean", "unsorted_segment_mean",
                                         "sqrt_n", "max",
                                         "unsorted_segment_max"])
def test_aggregate_flat_matches_jax(qm9, aggregation):
    """Plain segment aggregation, values and gradients; empty receivers get
    0 (sum family) or finfo.min (max). f32 sums in two orders."""
    _, _, jb, tb = qm9
    tg, jg = tb.graph, jb.graph
    msgs = _messages(tg, 11)
    w = np.random.RandomState(12).randn(tg.n_pad, D).astype(np.float32)
    got, want = _agg_vs_jax(
        lambda m: j_edge.aggregate_flat(m, jg.flat, jg.n_pad, aggregation),
        lambda m: t_edge.aggregate_flat(m, tg.flat, tg.n_pad, aggregation),
        msgs, w)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if aggregation.endswith("max"):
        empty = tg.node_has_incoming.numpy() == 0
        assert empty.any()
        assert (got[0][empty] == np.finfo(np.float32).min).all()


@pytest.mark.parametrize("aggregation", ["sum", "mean", "sqrt_n",
                                         "unsorted_segment_sqrt_n"])
def test_ranked_aggregation_matches_jax(qm9, aggregation):
    """aggregate_flat_auto on the ranked path (K5a forward, K5b VJP) with
    its count division, values and gradients, against the JAX package's
    ranked path in interpret mode."""
    _, _, jb, tb = qm9
    tg, jg = tb.graph, jb.graph
    assert t_edge.ranked_aggregation_ok(tg, aggregation)
    assert j_edge.ranked_aggregation_ok(jg, aggregation, 1, D)
    msgs = _messages(tg, 13)
    w = np.random.RandomState(14).randn(tg.n_pad, D).astype(np.float32)
    got, want = _agg_vs_jax(
        lambda m: j_layers.aggregate_flat_auto(m, jg, aggregation, "pallas"),
        lambda m: t_layers.aggregate_flat_auto(m, tg, aggregation, "pallas"),
        msgs, w)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TERMS)
    assert not t_edge.ranked_aggregation_ok(tg, "max")


def test_dense_adjacency_equals_jax(qm9):
    """A_l[v, u] built from the flat stream equals the JAX matrices built
    from the per-type edge blocks, exactly."""
    _, _, jb, tb = qm9
    got = t_edge.dense_adjacency(tb.graph).numpy()
    want = np.stack([np.asarray(a) for a in j_edge.dense_adjacency(jb.graph)])
    assert got.shape == want.shape == (tb.graph.num_edge_types, 640, 640)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == tb.graph.flat.mask.sum().item()


@pytest.mark.parametrize("strategy,n_pad,want", [
    ("auto", 640, True), ("dense", 10**6, True), ("segment", 640, False),
    ("pallas", 640, False), ("auto", 16384 + 128, False)])
def test_use_dense_strategy_matches_jax(qm9, strategy, n_pad, want):
    """The port picks the JAX package's path at the same shape."""
    _, _, jb, tb = qm9

    class Shape:
        num_edge_types = tb.graph.num_edge_types

    Shape.n_pad = n_pad
    assert t_layers.use_dense_strategy(Shape, "sum", strategy) == want
    assert j_layers.use_dense_strategy(Shape, "sum", strategy) == want
    assert not t_layers.use_dense_strategy(Shape, "max", strategy)


# ---- the layers ---------------------------------------------------------

LAYER_CASES = {
    "rgcn": {},
    "rgcn_unnormalised": {"normalize_by_num_incoming": False},
    "rgcn_src_and_tgt": {"use_both_source_and_target": True},
    "rgcn_leaky_relu": {"activation_function": "leaky_relu"},
    "ggnn_rnn": {"gated_unit_type": "rnn", "activation_function": "relu"},
    "ggnn_gru": {"gated_unit_type": "gru"},
    "ggnn_lstm": {"gated_unit_type": "lstm"},
}


def _layer_params(case, tg, seed):
    rng = np.random.RandomState(seed)
    L = tg.num_edge_types
    if case.startswith("rgcn"):
        in_dim = 2 * D if "src_and_tgt" in case else D
        return {"W": (0.3 * rng.randn(L, in_dim, D)).astype(np.float32)}
    g = {"rnn": 1, "gru": 3, "lstm": 4}[LAYER_CASES[case]["gated_unit_type"]]
    return {"W": (0.3 * rng.randn(L, D, D)).astype(np.float32),
            "cell": {"kernel": (0.2 * rng.randn(D, g * D)).astype(np.float32),
                     "recurrent_kernel": (0.2 * rng.randn(D, g * D)).astype(
                         np.float32),
                     "bias": (0.1 * rng.randn(g * D)).astype(np.float32)}}


def _run_layer(pkg, case, graph, params, h, w, strategy):
    kw = dict(LAYER_CASES[case], aggregation_strategy=strategy,
              num_timesteps=2)
    name = "rgcn" if case.startswith("rgcn") else "ggnn"
    if pkg == "jax":
        apply = getattr(j_layers, name + "_apply")

        def loss(p, hh):
            out = apply(p, graph, hh, **kw)
            return jnp.sum(out * w), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(params, h)
        return (np.asarray(out),
                jax.tree_util.tree_map(np.asarray, grads))
    apply = getattr(t_layers, name + "_apply")
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = apply(tp, graph, th, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    grads = (jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp),
             th.grad.numpy())
    return out.detach().numpy(), grads


@pytest.mark.parametrize("strategy", ["pallas", "segment", "dense"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(qm9, monkeypatch, case, strategy):
    """Output and every gradient of a 2-timestep RGCN / GGNN layer under
    each aggregation strategy, the same strategy on both sides. "segment"
    takes the plain f32 segment sums (JAX with interpret mode off, as at
    the tuned size) and "dense" the per-type adjacency matmuls (RGCN with
    source and target halves has no dense form and takes the segment sums
    on both sides): only f32 matmul and sum orders differ, within 1e-4 of
    the tensor's largest value. "pallas" takes the ranked K5 path on both
    (bf16-rounded messages, f32 sums): both round at the same places, but
    a message whose f32 value differs in its last bits may round to the
    neighbouring bf16 number, 2^-8 of itself. Such flips touch a few
    entries (measured: relative norm <= 2.3e-4, largest entry error <=
    1.6e-3 of the tensor's largest value); a wrong kernel moves every
    entry."""
    if strategy != "pallas":
        monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", False)
    _, _, jb, tb = qm9
    params = _layer_params(case, tb.graph, seed=len(case))
    rng = np.random.RandomState(5)
    h = rng.randn(tb.graph.n_pad, D).astype(np.float32)
    w = rng.randn(tb.graph.n_pad, D).astype(np.float32)
    got = _run_layer("torch", case, tb.graph, params, h, w, strategy)
    want = _run_layer("jax", case, jb.graph, params, h, w, strategy)
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want) == 2 + len(
        jax.tree_util.tree_leaves(params))
    for a, b in zip(flat_got, flat_want):
        scale = float(np.abs(b).max())
        if strategy == "pallas":
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3
            np.testing.assert_allclose(a, b, rtol=0, atol=2 ** -8 * scale)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)


# ---- the models ---------------------------------------------------------

def small_params(model, **extra):
    """The tuned QM9 hypers of `model` cut to hidden 32 and 2 layers, with
    dropout off (the two packages' random streams cannot match)."""
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "QM9_%s.json" % model)) as f:
        hypers = json.load(f)["model_params"]
    params = MODELS[model][0].default_params()
    params.update(hypers)
    params.update({"hidden_size": D, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 600})
    params.update(extra)
    return params


def test_hypers_are_copies():
    for model in MODELS:
        names = ["tf_gnn_samples_%s/default_hypers/QM9_%s.json" % (p, model)
                 for p in ("tpu", "torch")]
        with open(os.path.join(ROOT, names[0])) as a, \
                open(os.path.join(ROOT, names[1])) as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("strategy", ["auto", "pallas"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_loss_grads_and_rmsprop_step_match_jax(qm9, tmp_path, model,
                                                     strategy):
    """Loss, every parameter gradient and one clipped RMSProp step of the
    2-layer model, weights carried by params_from_jax. "auto" takes the
    dense strategy at this size (n_pad 640), "pallas" the ranked K5 path.
    Compared by norms: f32 matmul orders differ between the libraries
    (dense: loss within 1e-5, gradients 1e-4 relative), and on the ranked
    path a streamed value may also round to the neighbouring bf16 number,
    2^-8 of itself (measured: loss 1.3e-5, so within 1e-4, gradients
    <= 2.7e-5, so within 2e-4)."""
    jcls, tcls = MODELS[model]
    jt, tt, jb, tb = qm9
    params = small_params(model, aggregation_strategy=strategy)
    jm = jcls(dict(params), jt, "j", str(tmp_path))
    tm = tcls(dict(params), tt, "t", str(tmp_path), device="cpu")
    jflat0 = j_model.flatten_params(jm.model_params_tree)
    tm.load_weights(jflat0)
    assert t_model.params_to_jax(tm.model_params_tree).keys() == jflat0.keys()
    jdev = jm._device_batch(jb)
    tdev = t_model.batch_to_device(tb, CPU)

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True)(
            jm.model_params_tree)
    tloss, _ = tm._forward(tm.model_params_tree, tdev, None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    ranked = strategy == "pallas"
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-4 if ranked else 1e-5)
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, tgrads):
        rel = np.linalg.norm(g.numpy() - jflat[name]) / max(
            np.linalg.norm(jflat[name]), 1e-30)
        assert rel < (2e-4 if ranked else 1e-4), (name, rel)

    step = jm._make_train_step()
    jp, jo, _ = step(jm.model_params_tree, jm.opt_state,
                     jax.random.PRNGKey(0), jdev)
    tm._train_step(tdev)
    assert tm.opt_state.step == int(jo.step) == 1
    jflat = j_model.flatten_params(jp)
    tflat = t_model.params_to_jax(tm.model_params_tree)
    for name in jflat:
        # One RMSProp step moves a weight by ~lr / sqrt(0.02) = 4e-3; an
        # entry whose gradient is near zero takes a step set by the
        # gradient's last digits (measured well under a tenth of a step).
        np.testing.assert_allclose(tflat[name], jflat[name], rtol=1e-5,
                                   atol=5e-4, err_msg=name)


def write_subset(src, dst, count):
    with gzip.open(src, "rt") as fin, gzip.open(dst, "wt") as fout:
        fout.writelines(itertools.islice(fin, count))


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """A data directory with the first graphs of each bundled QM9 fold."""
    d = tmp_path_factory.mktemp("qm9_small_rgcn")
    for fold, count in (("train", 300), ("valid", 100), ("test", 150)):
        write_subset(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                     str(d / (fold + ".jsonl.gz")), count)
    return d


@pytest.mark.parametrize("model", sorted(MODELS))
def test_jax_checkpoint_restored_by_port(qm9, small_data, tmp_path, model):
    """A pickle the JAX package wrote loads into the port (registry.restore)
    and gives the same test loss and MAE; the GGNN cell's weights map by
    their flatten_params names."""
    jt = qm9[0]
    test_file = str(small_data / "test.jsonl.gz")
    jm = MODELS[model][0](small_params(model), jt, "j", str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))
    jdata = jm.task.load_eval_data_from_path(test_file)
    jloss, jmetrics, jgraphs, _, _, _ = jm._run_epoch(
        "Test", jdata, j_base.DataFold.TEST, quiet=True)

    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    assert isinstance(tm, MODELS[model][1])
    if model == "GGNN":
        assert tm.model_params_tree["prop"]["layers"][1]["gnn"]["cell"][
            "recurrent_kernel"].shape == (D, D)
    tdata = tm.task.load_eval_data_from_path(test_file)
    tloss, tmetrics, tgraphs, _, _, _ = tm._run_epoch(
        "Test", tdata, t_base.DataFold.TEST, quiet=True)
    assert tgraphs == jgraphs == 150
    mae = [sum(float(m["abs_err_task0"]) for m in ms) / 150
           for ms in (tmetrics, jmetrics)]
    np.testing.assert_allclose([tloss, mae[0]], [jloss, mae[1]], rtol=1e-5)


@pytest.mark.parametrize("alias,cls", [
    ("RGCN", "RGCN_Model"), ("rgcn_model", "RGCN_Model"),
    ("GGNN", "GGNN_Model"), ("ggnn_model", "GGNN_Model")])
def test_registry_resolves_ported_models(alias, cls):
    got, extra = t_registry.name_to_model_class(alias)
    assert got is getattr(t_model, cls) and extra == {}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_and_test_clis(small_data, tmp_path, model):
    """`python -m tf_gnn_samples_torch.train <model> QM9 --device cpu`
    writes the Train/Valid log lines and a best-model pickle that
    `python -m tf_gnn_samples_torch.test --device cpu` evaluates."""
    overrides = json.dumps({"max_epochs": 1, "hidden_size": 16,
                            "graph_num_layers": 2,
                            "max_nodes_in_batch": 2000})
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", model, "QM9",
         "--device", "cpu", "--data-path", str(small_data),
         "--result-dir", str(tmp_path), "--quiet",
         "--model-param-overrides", overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for fold in ("Train", "Valid"):
        m = re.search(r"^ %s: loss: (\S+) \|\| MAEs: " % fold, out.stdout,
                      re.M)
        assert m and np.isfinite(float(m.group(1))), out.stdout
    pickles = list(tmp_path.glob("QM9_%s_*_best_model.pickle" % model))
    assert len(pickles) == 1
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickles[0]),
         str(small_data / "test.jsonl.gz")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^Loss \d+\.\d{5} on 150 graphs$", out.stdout, re.M)
