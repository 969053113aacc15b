"""The port's fused GNN-FiLM path against the JAX package's, on a small
QM9 batch (max_nodes_in_batch 600: n_pad 640, E 10,240, where the JAX
package takes film_fused_src_pass): the three kernels' plain versions
against the Pallas kernels (interpret mode), the fused pass's VJP, and the
GNN-FiLM layer against aggregation_strategy "pallas" and "segment"."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

D = 32


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


@pytest.fixture(scope="module")
def batches():
    """(JAX GraphBatch, port GraphBatch) of the first 600-node QM9 pack."""
    out = []
    for mod, base in ((j_qm9, j_base), (t_qm9, t_base)):
        task = mod.QM9_Task(mod.QM9_Task.default_params())
        data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:200]
        out.append(next(task.make_minibatch_iterator(
            data, base.DataFold.VALIDATION, 600)).graph)
    jg, tg = out
    assert jg.n_pad == 640 and jg.flat.src_flat.shape[0] == 10240
    return jg, tg


def bf16_pair(x):
    """The same bf16 values for both packages (both round to nearest)."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    t = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                          t.to(torch.float32).numpy())
    return j, t


def i32(t):
    return jnp.asarray(t.numpy())


# Both sides sum the same bf16-rounded terms in f32, only in different
# orders (MXU dots over one-hot windows vs index_add_): a few f32 ulps of
# each row's sum (measured <= 1.4e-6 relative; the dump rank sums ~5,000
# terms to ~1.6e4). A term rounded to another bf16 value would be off by
# 2^-8 of itself and fail this.
TERMS = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,act", [
    ("fwd", "elu"), ("fwd", "relu"), ("fwd", "gelu"), ("fwd", "tanh"),
    ("fwd", "leaky_relu"), ("fwd", "linear"),
    ("dgb", "elu"), ("dgb", "relu"), ("src", "elu"), ("src", "relu"),
])
def test_kernel_plain_versions_match_pallas(batches, kernel, act):
    jg, tg = batches
    rng = np.random.RandomState(0)
    e = tg.flat.tgt_rank.shape[0]
    rpad = tg.flat.fine_to_flat.shape[0]
    rsrc = tg.flat.src_from_rank.shape[0]
    win_fine = token_window(jg.flat.win_fine)
    if kernel == "fwd":
        (jm, tm), (jt, tt) = (bf16_pair(rng.randn(e, D).astype(np.float32)),
                              bf16_pair(rng.randn(rpad, 2 * D).astype(np.float32)))
        want = j_rs._film_fwd_impl(jm, jt, i32(tg.flat.tgt_rank),
                                   block_edges=256, act=act, win=win_fine)
        got = t_rs._film_fwd_impl(tm, tt, tg.flat.tgt_rank, act=act)
    elif kernel == "dgb":
        (jm, tm), (jt, tt) = (bf16_pair(rng.randn(e, D).astype(np.float32)),
                              bf16_pair(rng.randn(rpad, 3 * D).astype(np.float32)))
        want = j_rs._film_bwd_dgb_impl(jm, jt, i32(tg.flat.tgt_rank),
                                       block_edges=256, act=act, win=win_fine)
        got = t_rs._film_bwd_dgb_impl(tm, tt, tg.flat.tgt_rank, act=act)
    else:
        (jc, tc), (jt, tt) = (bf16_pair(rng.randn(e, 3 * D).astype(np.float32)),
                              bf16_pair(rng.randn(rsrc, D).astype(np.float32)))
        want = j_rs._film_src_bwd_impl(
            jc, jt, i32(tg.flat.src_sorted_rank), table_rows=rsrc,
            block_edges=256, act=act, win=token_window(jg.flat.win_src))
        got = t_rs._film_src_bwd_impl(tc, tt, tg.flat.src_sorted_rank,
                                      table_rows=rsrc, act=act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TERMS)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


def test_wrappers_check_shapes():
    m = torch.zeros(8, 4, dtype=torch.bfloat16)
    ranks = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_rs._film_fwd_impl(m, torch.zeros(5, 7, dtype=torch.bfloat16),
                            ranks, act="elu")
    with pytest.raises(ValueError):
        t_rs._film_src_bwd_impl(torch.zeros(8, 12, dtype=torch.bfloat16),
                                torch.zeros(5, 4, dtype=torch.bfloat16),
                                ranks, table_rows=6, act="elu")


def fused_args(g, flat, lib):
    """film_fused_src_pass's index arguments of a batch, per package."""
    conv = i32 if lib == "jax" else (lambda t: t)
    return [conv(flat.src_flat), conv(flat.fine_rank_by_src),
            conv(flat.src_sorted_rank), conv(flat.src_to_rank),
            conv(flat.src_from_rank), conv(flat.tgt_rank)]


def test_fused_pass_vjp_matches_jax(batches):
    jg, tg = batches
    rng = np.random.RandomState(1)
    L, n_pad = tg.num_edge_types, tg.n_pad
    rpad = tg.flat.fine_to_flat.shape[0]
    jt, tt = bf16_pair(rng.randn(L * n_pad, D).astype(np.float32))
    gb = rng.randn(rpad, 2 * D).astype(np.float32)
    g = rng.randn(rpad, D).astype(np.float32)
    win = token_window(jg.flat.win_fine)
    win_src = token_window(jg.flat.win_src)

    def jfn(t_flat, gb_table):
        return j_rs.film_fused_src_pass(
            t_flat, gb_table, *fused_args(jg, tg.flat, "jax"), "elu", 256,
            win, win_src)

    jout, vjp = jax.vjp(jfn, jt, jnp.asarray(gb))
    jdt, jdgb = vjp(jnp.asarray(g))

    tt = tt.clone().requires_grad_(True)
    tgb = torch.from_numpy(gb).requires_grad_(True)
    tout = t_rs.film_fused_src_pass(tt, tgb, *fused_args(tg, tg.flat, "torch"),
                                    "elu")
    tdt, tdgb = torch.autograd.grad(tout, (tt, tgb), torch.from_numpy(g))
    assert tdt.dtype == torch.bfloat16 and tdgb.dtype == torch.float32
    assert jdt.dtype == jnp.bfloat16 and jdgb.dtype == jnp.float32
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TERMS)
    np.testing.assert_allclose(tdgb.numpy(), np.asarray(jdgb), **TERMS)
    # d_t is returned in bf16: sums that differ in their last f32 bits may
    # round to neighbouring bf16 values (2^-8 relative).
    np.testing.assert_allclose(tdt.to(torch.float32).numpy(),
                               np.asarray(jdt.astype(jnp.float32)),
                               rtol=8e-3, atol=1e-5)


def _layer_inputs(tg, seed=2):
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


def _jax_layer(jg, params, h, w, strategy):
    def loss(p, hh):
        out = j_layers.gnn_film_apply(p, jg, hh, activation_function="elu",
                                      aggregation_strategy=strategy)
        return jnp.sum(out * w), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(params, h)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def _torch_layer(tg, params, h, w, strategy):
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = t_layers.gnn_film_apply(tp, tg, th, activation_function="elu",
                                  aggregation_strategy=strategy)
    (out * torch.from_numpy(w)).sum().backward()
    grads = ({"W": tp["W"].grad.numpy(), "W_film": tp["W_film"].grad.numpy(),
              "ln": {k: v.grad.numpy() for k, v in tp["ln"].items()}},
             th.grad.numpy())
    return out.detach().numpy(), grads


def _compare(got, want, tol):
    out_t, (gp_t, gh_t) = got
    out_j, (gp_j, gh_j) = want
    np.testing.assert_allclose(out_t, out_j, **tol)
    np.testing.assert_allclose(gh_t, gh_j, **tol)
    for key in ("W", "W_film"):
        np.testing.assert_allclose(gp_t[key], gp_j[key], **tol)
    for key in ("scale", "bias"):
        np.testing.assert_allclose(gp_t["ln"][key], gp_j["ln"][key], **tol)


def test_film_layer_matches_jax_pallas(batches):
    """Fused branch of both packages: same bf16 stream, same kernels' math.
    Outputs are layer-normed O(1) values, parameter gradients are sums over
    640 nodes of magnitude up to ~60; both round at the same places, and
    only f32 matmul and sum orders differ (measured <= 3.3e-5 absolute)."""
    jg, tg = batches
    params, h, w = _layer_inputs(tg)
    want = _jax_layer(jg, params, h, w, "pallas")
    got = _torch_layer(tg, params, h, w, "auto")
    _compare(got, want, dict(rtol=1e-4, atol=1e-4))


def test_film_layer_segment_branch_matches_jax(batches, monkeypatch):
    """Plain f32 segment branch of both packages (tight), and the port's
    fused branch against the JAX segment branch (bf16 message stream and
    bf16-rounded terms: ~2^-8 relative). The JAX reference runs without
    interpret mode, so its gather VJPs stay the f32 XLA segment sums they
    are at the tuned QM9 size (forced interpret mode would route the
    64-wide gamma|beta gather's VJP through a bf16 Pallas kernel)."""
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", False)
    jg, tg = batches
    params, h, w = _layer_inputs(tg, seed=3)
    want = _jax_layer(jg, params, h, w, "segment")
    _compare(_torch_layer(tg, params, h, w, "segment"), want,
             dict(rtol=1e-4, atol=1e-4))
    _compare(_torch_layer(tg, params, h, w, "auto"), want,
             dict(rtol=3e-2, atol=2e-1))
