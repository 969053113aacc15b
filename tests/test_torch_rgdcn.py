"""The port's RGDCN against the JAX package's, on the CPU: the truncated
normal initializer, rgdcn_init's shapes, the three forms of the per-type
neighbour sums (dense, per-type, and the fine-rank form through the fused
gather + fine segment-sum, plain versions of K5a here), that fused op's
forward and VJP on an undiluted and a diluted src stream, rgdcn_apply for
its four weight-sharing variants and its per-channel branch, and a 2-layer
QM9 RGDCN model with its weights, an optimizer step, checkpoints and CLIs
carried across. Dropout is off: the packages' random streams cannot
match."""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import initializers as j_init
from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import edge_ops as j_edge_ops
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.utils import registry as j_registry
from tf_gnn_samples_torch.nn import initializers as t_init
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import edge_ops as t_edge_ops
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.utils import registry as t_registry

from test_torch_edge_mlp import count_calls
from test_torch_rgin import interpret, multi, qm9, small_data  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16
CPU = torch.device("cpu")
# (use_full_state_for_channel_weights, tie_channel_weights)
VARIANTS = [(False, False), (False, True), (True, False), (True, True)]


def test_truncated_normal_bound_and_spread():
    """Every draw within two standard deviations; the spread of a normal
    truncated at 2 sigma is 0.8796 sigma (the JAX package's draws agree);
    200,000 draws hold it to about 0.2 %, the tolerance 1 %."""
    std = 0.25
    t = t_init.truncated_normal(torch.Generator().manual_seed(0), (400, 500),
                                stddev=std)
    j = np.asarray(j_init.truncated_normal(jax.random.PRNGKey(0), (400, 500),
                                           stddev=std))
    assert t.shape == (400, 500) and t.dtype == torch.float32
    for x in (t.numpy(), j):
        assert np.abs(x).max() <= 2 * std
        np.testing.assert_allclose(x.std(), 0.8796 * std, rtol=1e-2)
        assert abs(x.mean()) < 1e-2 * std


@pytest.mark.parametrize("full,tie", VARIANTS)
def test_init_shapes_equal_jax(full, tie):
    """W_wc [L, C_eff, in_dim, K * K], stddev 1 / K^2 truncated at 2."""
    cfg = dict(num_channels=2, use_full_state_for_channel_weights=full,
               tie_channel_weights=tie)
    t = t_layers.rgdcn_init(torch.Generator().manual_seed(0), 5, D, **cfg)
    j = j_layers.rgdcn_init(jax.random.PRNGKey(0), 5, D, **cfg)
    assert t.keys() == j.keys() == {"W_wc"}
    assert tuple(t["W_wc"].shape) == j["W_wc"].shape == (
        5, 1 if tie else 2, D if full else D // 2, (D // 2) ** 2)
    assert float(t["W_wc"].abs().max()) <= 2.0 / (D // 2) ** 2


def sums_inputs(tg, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(tg.n_pad, D).astype(np.float32),
            rng.randn(tg.num_edge_types, tg.n_pad, D).astype(np.float32))


def jax_sums(jg, h, w, normalize, strategy, scan):
    def loss(hh):
        s = j_layers._typed_neighbor_sums(hh, jg, normalize, strategy, scan)
        return jnp.sum(s * w), s

    (_, s), dh = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(h))
    return np.asarray(s), np.asarray(dh)


def torch_sums(tg, h, w, normalize, strategy, scan):
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    s = t_layers._typed_neighbor_sums(th, tg, normalize, strategy, scan)
    (s * torch.from_numpy(w)).sum().backward()
    return s.detach().numpy(), th.grad.numpy()


@pytest.mark.parametrize("strategy,scan,form,normalize", [
    ("dense", "auto", "dense", False), ("segment", "unroll", "per_type", True)])
def test_neighbor_sums_match_jax(qm9, strategy, scan, form, normalize):
    """The dense and per-type forms against the JAX package's (interpret
    mode off, so its per-type loop runs f32 segment sums): the same f32
    sums in other orders, rtol 1e-5 and an atol of a few f32 ulps of the
    largest value."""
    _, _, jb, tb = qm9
    assert t_layers.rgdcn_sums_form(tb.graph, strategy, scan) == form
    h, w = sums_inputs(tb.graph)
    got = torch_sums(tb.graph, h, w, normalize, strategy, scan)
    want = jax_sums(jb.graph, h, w, normalize, strategy, scan)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("normalize", [False, True])
def test_fine_form_matches_jax_per_type_on_qm9(qm9, monkeypatch, normalize):
    """On a QM9 pack the port takes its fine form ("pallas" rules out the
    dense one; no window term), where the JAX package's gate takes the
    per-type f32 loop (the fine window is not compressive). The fine form
    sums bf16-rounded terms, each rounding within 2^-8 of the value (bf16's
    unit roundoff): a state rounded, and with normalisation the scaled
    term rounded again, so each sum lies within 2^-8 (2^-7) of its sum of
    |term| (+ f32 order) of the f32 one (measured 0.99 and 1.06 x 2^-8).
    Its backward rounds the fine table cotangent and the node cotangent to
    bf16: dh within 1 % of its norm (measured 0.27 %)."""
    _, _, jb, tb = qm9
    assert not j_layers.compressive_window(jb.graph.flat)
    assert t_layers.rgdcn_sums_form(tb.graph, "pallas", "auto") == "fine"
    calls = count_calls(monkeypatch, t_layers, "gather_aggregate_fine")
    h, w = sums_inputs(tb.graph, seed=1)
    s, dh = torch_sums(tb.graph, h, w, normalize, "pallas", "auto")
    assert len(calls) == 1
    s_want, dh_want = jax_sums(jb.graph, h, w, normalize, "pallas", "auto")
    # Sums of |term| by the port's per-type f32 form.
    s_abs, _ = torch_sums(tb.graph, np.abs(h), w, normalize, "segment",
                          "unroll")
    ulps = 2 if normalize else 1
    assert (np.abs(s - s_want) <= ulps * 2 ** -8 * s_abs + 1e-6).all()
    assert np.linalg.norm(dh - dh_want) <= 1e-2 * np.linalg.norm(dh_want)


def test_fine_form_matches_jax_fine_on_diluting_graph(multi, interpret,
                                                      monkeypatch):
    """On a graph whose fine window is compressive both packages take the
    fine form through their fused gather + fine segment-sum (JAX's Pallas
    kernels in interpret mode): the same bf16 terms, so the sums agree to
    f32 order. Without normalisation the backward takes the diluted src
    stream in both (test_gather_aggregate_fine_matches_jax holds the
    normalised op too). dh: JAX sums the L per-type bf16 cotangents of
    each node in bf16, the port in f32 with one rounding, so within 1 % of
    its norm (measured 0.2 %)."""
    normalize = False
    jg, tg = multi
    assert j_layers.compressive_window(jg.flat) and tg.flat.win_sd
    jcalls = count_calls(monkeypatch, j_edge_ops, "_gather_segsum_fine")
    tcalls = count_calls(monkeypatch, t_layers, "gather_aggregate_fine")
    h, w = sums_inputs(tg, seed=2)
    s, dh = torch_sums(tg, h, w, normalize, "pallas", "auto")
    s_want, dh_want = jax_sums(jg, h, w, normalize, "pallas", "auto")
    assert jcalls and len(tcalls) == 1
    np.testing.assert_allclose(s, s_want, rtol=1e-5,
                               atol=1e-6 * np.abs(s_want).max())
    assert np.linalg.norm(dh - dh_want) <= 1e-2 * np.linalg.norm(dh_want)


def fine_op_inputs(tg, seed):
    rng = np.random.RandomState(seed)
    rows = tg.flat.fine_to_flat.shape[0]
    table = rng.randn(tg.num_edge_types * tg.n_pad, D).astype(np.float32)
    return table, rng.randn(rows, D).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("which", ["qm9", "multi"])
def test_gather_aggregate_fine_matches_jax(request, interpret, which,
                                           normalize):
    """The fused gather + fine segment-sum op alone, forward table and the
    VJP to the bf16 node table, against the JAX package's (interpret mode):
    on a QM9 pack (undiluted src stream) and on the diluting graph (its
    diluted stream without normalisation). The same bf16 terms summed in
    f32 in other orders: rtol 1e-5; the VJP is rounded to bf16 in both and
    may differ by one bf16 ulp (2^-7 relative) where the f32 sums round
    apart."""
    if which == "qm9":
        _, _, jb, tb = request.getfixturevalue("qm9")
        jg, tg = jb.graph, tb.graph
    else:
        jg, tg = request.getfixturevalue("multi")
    assert t_edge_ops.gather_aggregate_fine_ok(tg)
    assert j_edge_ops.gather_aggregate_fine_ok(jg, D)
    table, w = fine_op_inputs(tg, seed=3)

    def jloss(t):
        out = j_edge_ops.gather_aggregate_fine(t, jg, normalize)
        return jnp.sum(out * w), out

    (_, jout), jd = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(table, jnp.bfloat16))
    tt = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    tout = t_edge_ops.gather_aggregate_fine(tt, tg, normalize)
    (tout * torch.from_numpy(w)).sum().backward()
    assert tuple(tout.shape) == jout.shape
    want = np.asarray(jout)
    np.testing.assert_allclose(tout.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert tt.grad.dtype == torch.bfloat16
    dwant = np.asarray(jd.astype(jnp.float32))
    np.testing.assert_allclose(tt.grad.float().numpy(), dwant, rtol=2 ** -7,
                               atol=1e-6 * np.abs(dwant).max())


def layer_inputs(tg, full, tie, channels=2, seed=0):
    rng = np.random.RandomState(seed)
    k = D // channels
    w_wc = (rng.randn(tg.num_edge_types, 1 if tie else channels,
                      D if full else k, k * k) / k ** 2).astype(np.float32)
    return ({"W_wc": w_wc}, rng.randn(tg.n_pad, D).astype(np.float32),
            rng.randn(tg.n_pad, D).astype(np.float32))


def jax_layer(jg, params, h, w, **cfg):
    weight = jnp.asarray(w) * jg.node_mask[:, None]

    def loss(p, hh):
        out = j_layers.rgdcn_apply(p, jg, hh, **cfg)
        return jnp.sum(out * weight), out

    (_, out), (gp, gh) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(h))
    return np.asarray(out), np.asarray(gp["W_wc"]), np.asarray(gh)


def torch_layer(tg, params, h, w, **cfg):
    tw = torch.from_numpy(params["W_wc"].copy()).requires_grad_(True)
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = t_layers.rgdcn_apply({"W_wc": tw}, tg, th, **cfg)
    (out * torch.from_numpy(w) * tg.node_mask[:, None]).sum().backward()
    return out.detach().numpy(), tw.grad.numpy(), th.grad.numpy()


def compare(tg, got, want, rel):
    """Output on real nodes, dW and dh, each within `rel` of its norm."""
    real = tg.node_mask.numpy() > 0
    pairs = [(got[0][real], want[0][real]), (got[1], want[1]),
             (got[2], want[2])]
    for a, b in pairs:
        assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b)


@pytest.mark.parametrize("full,tie", VARIANTS)
def test_layer_variants_match_jax(qm9, full, tie):
    """rgdcn_apply under sum for the four weight-sharing variants on a QM9
    pack ("auto": the dense form in both at this size): the same f32 math
    in other matmul and sum orders, each array within 1e-5 of its norm
    (measured under 3e-7)."""
    _, _, jb, tb = qm9
    cfg = dict(num_channels=2, use_full_state_for_channel_weights=full,
               tie_channel_weights=tie, activation_function="relu")
    params, h, w = layer_inputs(tb.graph, full, tie, seed=4)
    compare(tb.graph, torch_layer(tb.graph, params, h, w, **cfg),
            jax_layer(jb.graph, params, h, w, **cfg), 1e-5)


def test_per_channel_branch_matches_jax(qm9):
    """Max and mean aggregation take the per-channel branch (per-edge
    dynamic kernels over the flat stream in the port, per edge type in
    JAX's unrolled branch); mean here: the same f32 math, each array
    within 1e-5 of its norm (measured under 2e-7)."""
    _, _, jb, tb = qm9
    cfg = dict(num_channels=2, activation_function="relu",
               message_aggregation_function="mean")
    params, h, w = layer_inputs(tb.graph, False, False, seed=5)
    compare(tb.graph, torch_layer(tb.graph, params, h, w, **cfg),
            jax_layer(jb.graph, params, h, w, **cfg), 1e-5)


def test_sums_form_gate(qm9, multi):
    _, tg = multi
    qg = qm9[3].graph
    assert t_layers.rgdcn_sums_form(qg, "auto", "auto") == "dense"
    assert t_layers.rgdcn_sums_form(qg, "pallas", "auto") == "fine"
    assert t_layers.rgdcn_sums_form(qg, "segment", "unroll") == "per_type"
    assert t_layers.rgdcn_sums_form(tg, "segment", "auto") == "fine"
    for scan in ("scan", "always"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            t_layers.rgdcn_sums_form(tg, "auto", scan)
    assert t_layers.LAYERS["rgdcn"] == (t_layers.rgdcn_init,
                                        t_layers.rgdcn_apply)


# ---- the model -----------------------------------------------------------------

def small_params(**extra):
    """RGDCN's class defaults (the JAX package has no QM9_RGDCN.json) cut
    to hidden 16 in 2 channels of 8 and 2 layers, dropout off."""
    params = j_model.RGDCN_Model.default_params()
    params.update({"hidden_size": D, "num_channels": 2, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 600})
    params.update(extra)
    return params


def test_defaults_and_registry_equal_jax():
    tdef = t_model.RGDCN_Model.default_params()
    jdef = j_model.RGDCN_Model.default_params()
    assert tdef == {k: jdef[k] for k in tdef}
    assert not os.path.exists(os.path.join(
        ROOT, "tf_gnn_samples_tpu", "default_hypers", "QM9_RGDCN.json"))
    for name in ("RGDCN", "rgdcn", "rgdcn_model"):
        tcls, textra = t_registry.name_to_model_class(name)
        jcls, jextra = j_registry.name_to_model_class(name)
        assert tcls is t_model.RGDCN_Model and jcls is j_model.RGDCN_Model
        assert textra == jextra == {}
        assert tcls.name(tdef) == jcls.name(jdef) == "RGDCN"


@pytest.mark.parametrize("strategy", ["auto", "pallas"])
def test_model_loss_grads_and_step_match_jax(qm9, tmp_path, strategy):
    """Loss, every parameter gradient and one clipped RMSProp step of the
    2-layer model, weights carried by params_from_jax. "auto" takes the
    dense form in both at this size: the same f32 math (loss within 1e-5,
    each gradient within 1e-4 of its norm, the step within the RGCN test's
    limits). With "pallas" the port takes its fine form (bf16 states in the
    neighbour sums) and JAX its per-type f32 loop: compared by norms, loss
    and each gradient's norm within 2 %, each gradient within 5 % of its
    norm."""
    jt, tt, jb, tb = qm9
    params = small_params(aggregation_strategy=strategy)
    jm = j_model.RGDCN_Model(dict(params), jt, "j", str(tmp_path))
    tm = t_model.RGDCN_Model(dict(params), tt, "t", str(tmp_path),
                             device="cpu")
    assert tm.params["channel_dim"] == jm.params["channel_dim"] == D // 2
    jflat0 = j_model.flatten_params(jm.model_params_tree)
    tm.load_weights(jflat0)
    tflat0 = t_model.params_to_jax(tm.model_params_tree)
    assert {k: v.shape for k, v in tflat0.items()} == {
        k: np.asarray(v).shape for k, v in jflat0.items()}
    jdev = jm._device_batch(jb)
    tdev = t_model.batch_to_device(tb, CPU)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True))(
            jm.model_params_tree)
    tloss, _ = tm._forward(tm.model_params_tree, tdev, None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    dense = strategy == "auto"
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5 if dense else 2e-2)
    for name, g in zip(names, tgrads):
        norm = float(np.linalg.norm(jflat[name]))
        diff = float(np.linalg.norm(g.numpy() - jflat[name]))
        if dense:
            assert diff <= 1e-4 * norm, name
        else:
            assert abs(float(g.norm()) - norm) <= 2e-2 * norm, name
            assert diff <= 5e-2 * norm, name
    if not dense:
        return
    step = jm._make_train_step()
    jp, jo, _ = step(jm.model_params_tree, jm.opt_state,
                     jax.random.PRNGKey(0), jdev)
    tm._train_step(tdev)
    assert tm.opt_state.step == int(jo.step) == 1
    jflat = j_model.flatten_params(jp)
    tflat = t_model.params_to_jax(tm.model_params_tree)
    for name in jflat:
        np.testing.assert_allclose(tflat[name], jflat[name], rtol=1e-5,
                                   atol=5e-4, err_msg=name)


def test_checkpoints_cross_packages(qm9, small_data, tmp_path):
    """A JAX-written RGDCN pickle loads into the port (the same test loss,
    on the dense form in both) and the port's pickle loads back into
    JAX."""
    jt = qm9[0]
    test_file = str(small_data / "test.jsonl.gz")
    jm = j_model.RGDCN_Model(small_params(), jt, "j", str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))

    def eval_loss(model, base):
        data = model.task.load_eval_data_from_path(test_file)
        return model._run_epoch("Test", data, base.DataFold.TEST,
                                quiet=True)[0]

    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    assert type(tm) is t_model.RGDCN_Model
    jloss = eval_loss(jm, j_base)
    np.testing.assert_allclose(eval_loss(tm, t_base), jloss, rtol=1e-5)
    tm.save_model(str(tmp_path / "torch.pickle"))
    with open(tmp_path / "torch.pickle", "rb") as f:
        saved = pickle.load(f)
    assert saved["model_class"] == "RGDCN"
    assert saved["weights"].keys() == j_model.flatten_params(
        jm.model_params_tree).keys()
    jm2 = j_registry.restore(str(tmp_path / "torch.pickle"), str(tmp_path))
    np.testing.assert_allclose(eval_loss(jm2, j_base), jloss, rtol=1e-6)


def test_train_and_test_clis(small_data, tmp_path):
    """`python -m tf_gnn_samples_torch.train RGDCN QM9 --device cpu` at the
    class defaults cut to 2 layers and hidden 16 ("pallas": the fine form,
    plain K5a on the CPU) writes the log lines the bench scripts parse and
    a checkpoint that the test CLI restores."""
    overrides = json.dumps({"max_epochs": 1, "hidden_size": 16,
                            "num_channels": 2, "graph_num_layers": 2,
                            "max_nodes_in_batch": 2000,
                            "aggregation_strategy": "pallas"})
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "RGDCN", "QM9",
         "--device", "cpu", "--data-path", str(small_data), "--result-dir",
         str(tmp_path), "--quiet", "--model-param-overrides", overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = r" %s: loss: \d+\.\d{5} \|\| MAEs: 0:\d+\.\d{5} \| Error Ratios: " \
           r"0:\d+\.\d{5} \|\| graphs/sec: \d+\.\d{2} \| nodes/sec: \d+ \| " \
           r"edges/sec: \d+$"
    lines = out.stdout.splitlines()
    assert any(re.match(line % "Train", l) for l in lines), out.stdout
    assert any(re.match(line % "Valid", l) for l in lines), out.stdout
    pickles = list(tmp_path.glob("QM9_RGDCN_*_best_model.pickle"))
    assert len(pickles) == 1
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickles[0]),
         str(small_data / "test.jsonl.gz")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^Loss \d+\.\d{5} on 150 graphs$", out.stdout, re.M)
