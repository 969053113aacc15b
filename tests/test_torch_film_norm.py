"""GNN-FiLM's ranked branch (K1 forward, K4 backward: the normalised
configuration) and the gather-fused pass on a diluted src stream, the port
against the JAX package on the CPU.

Inputs come from numpy with a fixed seed and go to both packages; the JAX
side runs its Pallas kernels in interpret mode, the port the kernels'
plain versions. Batches: the first 600-node QM9 pack (n_pad 640, E 10,240;
fine window 0, so its src stream is undiluted in both packages) and a
numpy-made graph of PPI-like degree, where the diluted stream engages.
Layers and models are compared at 64 columns: from there the JAX gather's
VJP takes its ranked form in interpret mode, the form the port always
takes."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import graph as j_graph
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

from test_torch_graph import ppi_like_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
D = 64

# Both sides sum the same bf16-rounded terms in f32, in different orders: a
# few f32 ulps of each row's sum (tests/test_torch_film.py TERMS).
TERMS = dict(rtol=1e-5, atol=1e-5)


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
    assert tb.graph.flat.win_sd == 0
    return jt, tt, jb, tb


@pytest.fixture(scope="module")
def ppi():
    """(JAX GraphBatch, port GraphBatch) of a PPI-like graph whose diluted
    src stream engaged, edge blocks padded to whole 2048-edge rows."""
    feats, adj, gids = ppi_like_graph(3, num_nodes=500, degree=12)
    e_pads = [-(-a.shape[0] // 2048) * 2048 for a in adj]
    jg = j_graph.pad_graph_batch(feats, adj, gids, 2, e_pads=e_pads)
    tg = t_graph.pad_graph_batch(feats, adj, gids, 2, e_pads=e_pads)
    assert tg.flat.win_sd and tg.flat.sd_rank.shape[0] > tg.flat.src_flat.shape[0]
    assert (tg.flat.sd_fine == int(t_graph.SD_FILL)).any()
    return jg, tg


def bf16_pair(x):
    """The same bf16 values for both packages (both round to nearest)."""
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def i32(t):
    return jnp.asarray(t.numpy())


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


# ---- K4 -----------------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "leaky_relu", "linear", "elu",
                                 "tanh", "gelu"])
def test_film_bwd_plain_matches_pallas(qm9, act):
    """K4's plain version against _film_bwd_impl in interpret mode on the
    QM9 fine ranks. d_gb: the same bf16 terms summed in f32 in two orders
    (TERMS). d_msgs = bf16(gamma * act'(z) * g): for the piecewise-linear
    activations every f32 step is the same on both sides, so it is equal
    bit for bit; elu, tanh and gelu go through two libraries' exp / tanh,
    which differ by an ulp, so a value may round to the neighbouring bf16
    number (2^-8 relative) and the terms of d_gb likewise (2^-8 of a row's
    largest term; atol 2e-2 covers rows of ~3 terms of magnitude ~2).
    Where act' itself cancels (1 - tanh^2 near saturation, gelu's 1 + erf
    in the negative tail) a few ulps of 1.0 (6e-8 each, twice for the
    square) are an absolute error times gamma * g, which reaches about 10
    here: atol 1e-5 on d_msgs."""
    _, _, jb, tb = qm9
    flat = tb.graph.flat
    rng = np.random.RandomState(0)
    e, rpad = flat.tgt_rank.shape[0], flat.fine_to_flat.shape[0]
    jm, tm = bf16_pair(rng.randn(e, D).astype(np.float32))
    jt, tt = bf16_pair(rng.randn(rpad, 3 * D).astype(np.float32))
    jdm, jdgb = j_rs._film_bwd_impl(
        jm, jt, i32(flat.tgt_rank), block_edges=256, act=act,
        win=token_window(jb.graph.flat.win_fine))
    tdm, tdgb = t_rs._film_bwd_impl(tm, tt, flat.tgt_rank, act=act)
    assert tdm.dtype == torch.bfloat16 and tdm.shape == (e, D)
    assert tdgb.dtype == torch.float32 and tdgb.shape == (rpad, 2 * D)
    if act in ("relu", "leaky_relu", "linear"):
        np.testing.assert_array_equal(f32(tdm), f32(jdm))
        np.testing.assert_allclose(tdgb.numpy(), np.asarray(jdgb), **TERMS)
    else:
        np.testing.assert_allclose(f32(tdm), f32(jdm), rtol=2 ** -7,
                                   atol=1e-5)
        assert (f32(tdm) != f32(jdm)).mean() < 1e-2
        np.testing.assert_allclose(tdgb.numpy(), np.asarray(jdgb),
                                   rtol=2 ** -7, atol=2e-2)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions
    assert "film_bwd" in t_rs.LAUNCHES


def test_film_bwd_wrapper_checks_shapes():
    m = torch.zeros(8, 4, dtype=torch.bfloat16)
    ranks = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):  # the table is gamma | beta only
        t_rs._film_bwd_impl(m, torch.zeros(5, 8, dtype=torch.bfloat16),
                            ranks, act="elu")
    with pytest.raises(ValueError):
        t_rs._film_bwd_impl(m, torch.zeros(5, 12, dtype=torch.bfloat16),
                            ranks[:7], act="elu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_film_ranked_aggregate_vjp_matches_jax(qm9, dtype):
    """Forward and VJP of film_ranked_aggregate (relu: see the K4 test) for
    the bf16 stream the layer feeds and an f32 one: d_msgs in the stream's
    dtype, d_gb in the table's (f32). Same bf16 terms, two f32 sum orders
    (TERMS); d_msgs is one rounded product, equal bit for bit."""
    _, _, jb, tb = qm9
    flat = tb.graph.flat
    rng = np.random.RandomState(1)
    e, rpad = flat.tgt_rank.shape[0], flat.fine_to_flat.shape[0]
    m = rng.randn(e, D).astype(np.float32)
    gb = rng.randn(rpad, 2 * D).astype(np.float32)
    g = rng.randn(rpad, D).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    win = token_window(jb.graph.flat.win_fine)
    jout, vjp = jax.vjp(
        lambda a, b: j_rs.film_ranked_aggregate(a, b, i32(flat.tgt_rank),
                                                "relu", 256, win),
        jnp.asarray(m).astype(jdt), jnp.asarray(gb))
    jdm, jdgb = vjp(jnp.asarray(g))
    tm = torch.from_numpy(m).to(tdt).requires_grad_(True)
    tgb = torch.from_numpy(gb).requires_grad_(True)
    tout = t_rs.film_ranked_aggregate(tm, tgb, flat.tgt_rank, "relu")
    tdm, tdgb = torch.autograd.grad(tout, (tm, tgb), torch.from_numpy(g))
    assert tdm.dtype == tdt and tdgb.dtype == torch.float32
    assert jdm.dtype == jdt and jdgb.dtype == jnp.float32
    np.testing.assert_allclose(f32(tout), f32(jout), **TERMS)
    np.testing.assert_array_equal(f32(tdm), f32(jdm))
    np.testing.assert_allclose(f32(tdgb), f32(jdgb), **TERMS)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_film_aggregate_splits_match_jax(qm9, splits):
    """_film_aggregate_splits at 1, 2 and 4 column slices against the JAX
    function, value and both gradients; the slices are independent, so
    every count gives what the unsplit call gives (TERMS)."""
    _, _, jb, tb = qm9
    flat = tb.graph.flat
    rng = np.random.RandomState(2)
    e, rpad = flat.tgt_rank.shape[0], flat.fine_to_flat.shape[0]
    jm, tm = bf16_pair(rng.randn(e, D).astype(np.float32))
    gb = rng.randn(rpad, 2 * D).astype(np.float32)
    g = rng.randn(rpad, D).astype(np.float32)
    win = token_window(jb.graph.flat.win_fine)
    jout, vjp = jax.vjp(
        lambda a, b: j_layers._film_aggregate_splits(a, b, jb.graph, "relu",
                                                     win, splits),
        jm, jnp.asarray(gb))
    jdm, jdgb = vjp(jnp.asarray(g))
    tm = tm.clone().requires_grad_(True)
    tgb = torch.from_numpy(gb).requires_grad_(True)
    tout = t_layers._film_aggregate_splits(tm, tgb, tb.graph, "relu", splits)
    tdm, tdgb = torch.autograd.grad(tout, (tm, tgb), torch.from_numpy(g))
    np.testing.assert_allclose(f32(tout), f32(jout), **TERMS)
    np.testing.assert_array_equal(f32(tdm), f32(jdm))
    np.testing.assert_allclose(f32(tdgb), f32(jdgb), **TERMS)
    one = t_layers._film_aggregate_splits(tm, tgb, tb.graph, "relu", 1)
    np.testing.assert_allclose(f32(tout), f32(one), **TERMS)
    # No shape makes the port split: its kernels keep no table on chip.
    assert t_rs.film_column_splits(161792, 128, 162056) == 1
    assert j_rs.film_column_splits(161792, 128, 162056) == 0


# ---- the gather-fused pass on a diluted stream ----------------------------

@pytest.mark.parametrize("act", ["relu", "elu"])
def test_fused_src_pass_on_diluted_stream_matches_jax(ppi, act):
    """film_fused_src_pass fed the fill-extended DILUTED src stream
    (sd_fine with SD_FILL keys, sd_rank; longer than the edge stream), with
    a cotangent that is non-zero on every table row, slack rows included:
    the fill slots clamp onto an appended zero row and add nothing. d_t
    also equals what the undiluted stream gives, up to the f32 sum order.
    dgb TERMS; d_t is returned in bf16, so sums that differ in their last
    f32 bits may round to neighbouring bf16 values (rtol 8e-3, as
    tests/test_torch_film.py); elu also meets two libraries' exp."""
    jg, tg = ppi
    jf, tf = jg.flat, tg.flat
    rng = np.random.RandomState(3)
    L, n_pad = tg.num_edge_types, tg.n_pad
    rpad = tf.fine_to_flat.shape[0]
    jt, tt = bf16_pair(rng.randn(L * n_pad, D).astype(np.float32))
    gb = rng.randn(rpad, 2 * D).astype(np.float32)
    g = rng.randn(rpad, D).astype(np.float32)
    sd_fine, sd_rank, win_src = j_layers.src_stream(jf)
    assert win_src == tf.win_sd and sd_rank.shape[0] == tf.sd_rank.shape[0]
    jout, vjp = jax.vjp(
        lambda a, b: j_rs.film_fused_src_pass(
            a, b, jf.src_flat, sd_fine, sd_rank, jf.src_to_rank,
            jf.src_from_rank, jf.tgt_rank, act, 256,
            token_window(jf.win_fine), win_src),
        jt, jnp.asarray(gb))
    jdt, jdgb = vjp(jnp.asarray(g))

    def port(fine, rank):
        t = tt.clone().requires_grad_(True)
        tgb = torch.from_numpy(gb).requires_grad_(True)
        out = t_rs.film_fused_src_pass(
            t, tgb, tf.src_flat, fine, rank, tf.src_to_rank,
            tf.src_from_rank, tf.tgt_rank, act)
        return (out,) + torch.autograd.grad(out, (t, tgb),
                                            torch.from_numpy(g))

    t_fine, t_rank, t_win = t_layers.src_stream(tf)
    assert t_win == tf.win_sd and t_fine is tf.sd_fine and t_rank is tf.sd_rank
    tout, tdt, tdgb = port(t_fine, t_rank)
    loose = act == "elu"
    np.testing.assert_allclose(f32(tout), f32(jout), rtol=2 ** -7 if loose
                               else 1e-5, atol=2e-2 if loose else 1e-5)
    np.testing.assert_allclose(f32(tdgb), f32(jdgb), rtol=2 ** -7 if loose
                               else 1e-5, atol=2e-2 if loose else 1e-5)
    np.testing.assert_allclose(f32(tdt), f32(jdt), rtol=8e-3,
                               atol=3e-2 if loose else 1e-5)
    _, udt, _ = port(tf.fine_rank_by_src, tf.src_sorted_rank)
    np.testing.assert_allclose(f32(tdt), f32(udt), rtol=8e-3, atol=1e-5)


# ---- the layer and the model ----------------------------------------------

def _layer_inputs(tg, seed):
    rng = np.random.RandomState(seed)
    L = tg.num_edge_types
    params = {
        "W": (0.2 * rng.randn(L, D, D)).astype(np.float32),
        "W_film": (0.2 * rng.randn(L, D, 2 * D)).astype(np.float32),
        "ln": {"scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
               "bias": (0.1 * rng.randn(D)).astype(np.float32)},
    }
    h = rng.randn(tg.n_pad, D).astype(np.float32)
    w = rng.randn(tg.n_pad, D).astype(np.float32)
    return params, h, w


def _run_layer(pkg, graph, params, h, w, **kw):
    """[out, dW, dW_film, dscale, dbias, dh] of gnn_film_apply under the
    loss sum(out * w), as numpy arrays."""
    if pkg == "jax":
        def loss(p, hh):
            out = j_layers.gnn_film_apply(p, graph, hh, **kw)
            return jnp.sum(out * w), out

        (_, out), (gp, gh) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, h)
        return [np.asarray(a) for a in (out, gp["W"], gp["W_film"],
                                        gp["ln"]["scale"], gp["ln"]["bias"],
                                        gh)]
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = t_layers.gnn_film_apply(tp, graph, th, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return [a.detach().numpy() for a in (
        out, tp["W"].grad, tp["W_film"].grad, tp["ln"]["scale"].grad,
        tp["ln"]["bias"].grad, th.grad)]


NAMES = ("out", "dW", "dW_film", "dscale", "dbias", "dh")


def _assert_close(got, want, rel_tol, abs_share):
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < rel_tol, (name, rel)
        np.testing.assert_allclose(
            a, b, rtol=0, atol=abs_share * float(np.abs(b).max()),
            err_msg=name)


@pytest.mark.parametrize("graph_name,normalize", [
    ("qm9", True), ("ppi", True), ("ppi", False), ("qm9", False)])
def test_film_layer_ranked_and_diluted_match_jax(qm9, ppi, monkeypatch,
                                                 graph_name, normalize):
    """A 2-timestep GNN-FiLM layer (elu), output and the gradients with
    respect to W, W_film, the LayerNorm parameters and h.

    normalize=True: both packages take the K4 branch (bf16 gather, m * 1/c
    in bf16, film_ranked_aggregate, the ranked gather's backward).
    normalize=False on the PPI-like graph: both take the gather-fused pass
    on the DILUTED src stream. ("qm9", False) sends the unnormalised layer
    down the K4 branch in both packages through ENABLE_FUSED_SRC_PASS.

    Both sides round at the same places, but a value whose f32 bits differ
    (matmul and sum orders, exp) may round to the neighbouring bf16 number,
    2^-8 of itself: held to 2e-3 relative norm and 2^-7 of the tensor's
    largest value per entry (measured: <= 1.7e-4 and <= 2.7e-3); a wrong
    kernel or rounding point moves every entry."""
    jg, tg = (qm9[2].graph, qm9[3].graph) if graph_name == "qm9" else ppi
    if (graph_name, normalize) == ("qm9", False):
        monkeypatch.setattr(j_rs, "ENABLE_FUSED_SRC_PASS", False)
        monkeypatch.setattr(t_rs, "ENABLE_FUSED_SRC_PASS", False)
    params, h, w = _layer_inputs(tg, seed=5 + normalize)
    kw = dict(activation_function="elu", num_timesteps=2,
              normalize_by_num_incoming=normalize,
              aggregation_strategy="pallas")
    calls = {"k4": 0, "fused": 0}
    for name, fn in (("k4", "film_ranked_aggregate"),
                     ("fused", "film_fused_src_pass")):
        orig = getattr(t_rs, fn)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(t_rs, fn, spy)
    got = _run_layer("torch", tg, params, h, w, **kw)
    want = _run_layer("jax", jg, params, h, w, **kw)
    k4 = normalize or graph_name == "qm9"
    assert calls == {"k4": 2 * k4, "fused": 2 * (not k4)}
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions
    _assert_close(got, want, 2e-3, 2 ** -7)


def test_normalised_layer_is_the_segment_branch_up_to_bf16(qm9, monkeypatch):
    """The K4 branch against the port's own plain f32 segment branch on the
    normalised layer: the same function up to the bf16 stream and the
    bf16-rounded terms (rtol 3e-2, atol 2e-1 of tests/test_torch_film.py),
    and film_fused_branch no longer depends on the normalisation."""
    tg = qm9[3].graph
    params, h, w = _layer_inputs(tg, seed=9)
    kw = dict(activation_function="elu", normalize_by_num_incoming=True)
    ranked = _run_layer("torch", tg, params, h, w,
                        aggregation_strategy="auto", **kw)
    plain = _run_layer("torch", tg, params, h, w,
                       aggregation_strategy="segment", **kw)
    for name, a, b in zip(NAMES, ranked, plain):
        np.testing.assert_allclose(a, b, rtol=3e-2, atol=2e-1, err_msg=name)
    assert t_layers.film_fused_branch("auto", "sum", "elu")
    assert not t_layers.film_fused_branch("segment", "sum", "elu")
    assert not t_layers.film_fused_branch("auto", "max", "elu")
    assert not t_layers.film_fused_branch("auto", "sum", "swish")


def small_params(**extra):
    """The tuned QM9 GNN-FiLM hypers with normalised messages, cut to
    hidden 64 and 2 layers, dropout off."""
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "QM9_GNN-FiLM.json")) as f:
        hypers = json.load(f)["model_params"]
    params = j_model.GNN_FiLM_Model.default_params()
    params.update(hypers)
    params.update({"hidden_size": D, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 600,
                   "normalize_messages_by_num_incoming": True})
    params.update(extra)
    return params


def test_normalised_model_loss_grads_and_steps_match_jax(qm9, tmp_path):
    """Loss, every parameter gradient and two clipped RMSProp steps of the
    2-layer normalised GNN-FiLM model, weights carried by params_from_jax
    (load_weights). Compared by norms, as deep bf16-streamed models must be:
    loss 1e-4, gradients 1e-3 relative (measured 4.4e-6 and <= 4.2e-5)."""
    jt, tt, jb, tb = qm9
    params = small_params()
    jm = j_model.GNN_FiLM_Model(dict(params), jt, "j", str(tmp_path))
    tm = t_model.GNN_FiLM_Model(dict(params), tt, "t", str(tmp_path),
                                device="cpu")
    tm.load_weights(j_model.flatten_params(jm.model_params_tree))
    jdev = jm._device_batch(jb)
    tdev = t_model.batch_to_device(tb, CPU)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True)(
            jm.model_params_tree)
    tloss, _ = tm._forward(tm.model_params_tree, tdev, None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4)
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, tgrads):
        rel = np.linalg.norm(g.numpy() - jflat[name]) / max(
            np.linalg.norm(jflat[name]), 1e-30)
        assert rel < 1e-3, (name, rel)
    step = jm._make_train_step()
    jp, jo = jm.model_params_tree, jm.opt_state
    for i in range(2):
        jp, jo, _ = step(jp, jo, jax.random.PRNGKey(i), jdev)
        tm._train_step(tdev)
    jflat = j_model.flatten_params(jp)
    tflat = t_model.params_to_jax(tm.model_params_tree)
    for name in jflat:
        # One RMSProp step moves a weight by ~lr / sqrt(0.02) = 4e-3; an
        # entry whose gradient is near zero takes a step set by the
        # gradient's last digits.
        np.testing.assert_allclose(tflat[name], jflat[name], rtol=1e-5,
                                   atol=1e-3, err_msg=name)
