"""The port's primitives (tf_gnn_samples_torch) against the JAX package's:
activations, the FiLM kernels' (act, act') table, initializers,
layer_norm, mlp, per-tensor clipping and one update of each optimizer.
Inputs come from numpy with a fixed seed and go to both packages."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import activations as j_act
from tf_gnn_samples_tpu.nn import mlp as j_mlp
from tf_gnn_samples_tpu.nn import normalization as j_norm
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.runtime import optimizers as j_opt
from tf_gnn_samples_torch.nn import activations as t_act
from tf_gnn_samples_torch.nn import initializers as t_init
from tf_gnn_samples_torch.nn import mlp as t_mlp
from tf_gnn_samples_torch.nn import normalization as t_norm
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.runtime import optimizers as t_opt

# Elementwise f32 math in two libraries (XLA's CPU exp/tanh/erf against
# PyTorch's): they differ by a few ulps, never more.
F32_ULPS = dict(rtol=2e-6, atol=2e-6)


def _x(seed=0, shape=(64, 33)):
    return (3.0 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(j_act._ACTIVATIONS))
def test_activations_match_jax(name):
    x = _x()
    got = t_act.get_activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(j_act.get_activation(name)(jnp.asarray(x)))
    if name != "gelu":
        np.testing.assert_allclose(got, want, **F32_ULPS)
        return
    # Both libraries compute 0.5 * x * (1 + erf(x / sqrt 2)) in f32. In the
    # negative tail 1 + erf cancels: an error of k ulps of 1.0 (2^-24 each)
    # in either library's erf becomes |x| / 2 * k * 2^-24 in the result,
    # whatever the result's own size (at x = -9.35 one ulp decides between
    # -0.0 and -8.4e-7). k = 8 covers a few ulps of erf in each library;
    # each is also held to the formula evaluated in float64.
    cancel = np.abs(x) / 2 * 8 * 2.0 ** -24
    tol = F32_ULPS["atol"] + cancel + F32_ULPS["rtol"] * np.abs(want)
    x64 = x.astype(np.float64)
    exact = 0.5 * x64 * (1.0 + np.vectorize(math.erf)(x64 / math.sqrt(2.0)))
    for a, b in ((got, want), (got, exact), (want, exact)):
        assert (np.abs(a - b) <= tol).all(), float((np.abs(a - b) - tol).max())


@pytest.mark.parametrize("name", sorted(j_act._ACTIVATIONS))
def test_activation_gradients_match_jax(name):
    """Derivatives, including at exactly +-0, where the ranked aggregation's
    sums of bf16-rounded terms often land (leaky_relu's is 1 there)."""
    x = _x(1).reshape(-1)
    x[:8] = [0.0, -0.0, 0.0, -0.0, 1e-30, -1e-30, 0.0, 0.0]
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(t_act.get_activation(name)(tx).sum(), tx)
    want = jax.grad(lambda a: jnp.sum(j_act.get_activation(name)(a)))(
        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_ULPS)


def test_clamped_exp_gradient_matches_jax_at_the_clamp():
    """The ranked softmaxes' exp(clip(x, -50, 50)): at exactly +-50
    jnp.clip's derivative is 1/2 (a minimum of a maximum, ties split) and
    torch.clamp's is 1, so the port's clip is written as the same minimum
    of a maximum; beyond the clamp both give 0."""
    from tf_gnn_samples_torch.ops.edge_ops import _clamped_exp

    x = np.array([-50.0, 50.0, -50.000004, 50.000004, -49.999996, 49.999996,
                  0.0, -80.0, 80.0, 3.5], np.float32)
    want = np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.exp(jnp.clip(a, -50.0, 50.0))))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(_clamped_exp(tx, 50.0).sum(), tx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.numpy()[:2],
                               0.5 * np.exp(x[:2].astype(np.float64)),
                               rtol=1e-6)
    assert (got.numpy()[[2, 3, 7, 8]] == 0).all()
    ty = torch.from_numpy(x).requires_grad_(True)
    (clamp,) = torch.autograd.grad(torch.clamp(ty, -50.0, 50.0).sum(), ty)
    assert (clamp.numpy()[:2] == 1).all()  # why torch.clamp is not used


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        t_act.get_activation("swish")


@pytest.mark.parametrize("name", sorted(j_rs._ACTS))
def test_film_act_table_matches_jax(name):
    """act and act' of the fused kernels, including _erf_approx for gelu."""
    x = _x(1)
    for i in (0, 1):
        got = t_rs._ACTS[name][i](torch.from_numpy(x)).numpy()
        want = np.asarray(j_rs._ACTS[name][i](jnp.asarray(x)))
        np.testing.assert_allclose(got, want, **F32_ULPS)
    assert set(t_rs._ACTS) == set(j_rs._ACTS) == set(t_rs.ACT_IDS)


def test_stacked_glorot_uniform_bounds():
    """Same distribution as the JAX initializer (the numbers differ: torch
    and jax.random are different generators): U(-l, l) per [D_in, D_out]
    slice, l = sqrt(6 / (D_in + D_out))."""
    gen = torch.Generator().manual_seed(0)
    w = t_init.stacked_glorot_uniform(gen, 5, (64, 192))
    limit = math.sqrt(6.0 / (64 + 192))
    assert w.shape == (5, 64, 192) and w.dtype == torch.float32
    assert float(w.abs().max()) <= limit
    # Uniform on [-l, l] has std l / sqrt(3); 61k samples pin it to <1%.
    assert abs(float(w.std()) / (limit / math.sqrt(3.0)) - 1.0) < 0.01
    again = t_init.stacked_glorot_uniform(torch.Generator().manual_seed(0),
                                          5, (64, 192))
    assert torch.equal(w, again)


def test_layer_norm_matches_jax():
    x = _x(2)
    rng = np.random.RandomState(3)
    params = {"scale": (1 + 0.1 * rng.randn(33)).astype(np.float32),
              "bias": (0.1 * rng.randn(33)).astype(np.float32)}
    got = t_norm.layer_norm({k: torch.from_numpy(v) for k, v in params.items()},
                            torch.from_numpy(x)).numpy()
    want = np.asarray(j_norm.layer_norm(params, jnp.asarray(x)))
    # f32 mean/var reductions in two orders: a few ulps of O(1) outputs.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert t_norm.layer_norm_init(7)["scale"].shape == (7,)


def test_mlp_matches_jax():
    rng = np.random.RandomState(4)
    sizes = [33, 16, 8, 5]
    layers = [{"kernel": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
               "bias": rng.randn(b).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    x = _x(5)
    got = t_mlp.mlp_apply(
        {"layers": [{k: torch.from_numpy(v) for k, v in l.items()}
                    for l in layers]},
        torch.from_numpy(x), activation_fn=torch.tanh).numpy()
    want = np.asarray(j_mlp.mlp_apply({"layers": layers}, jnp.asarray(x),
                                      activation_fn=jnp.tanh))
    # f32 matmuls of depth <= 33 in two libraries.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    init = t_mlp.mlp_init(torch.Generator().manual_seed(0), 33, 5,
                          hidden_layers=[16, 8], use_biases=True)
    assert [l["kernel"].shape for l in init["layers"]] == [
        (33, 16), (16, 8), (8, 5)]


def _tensors(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(7, 5).astype(np.float32) * s for s in (0.01, 1.0, 30.0)]


def test_clip_grads_per_tensor_matches_jax():
    grads = _tensors(6)
    got = t_opt.clip_grads_per_tensor([torch.from_numpy(g) for g in grads],
                                      1.0)
    want = j_opt.clip_grads_per_tensor([jnp.asarray(g) for g in grads], 1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_ULPS)


@pytest.mark.parametrize("name", ["SGD", "Adam", "RMSProp"])
def test_optimizer_updates_match_jax(name):
    """Two updates from the same params and grads (TF1 semantics)."""
    hp = {"optimizer": name, "learning_rate_decay": 0.98, "momentum": 0.85}
    params = _tensors(7)
    j = j_opt.make_optimizer(hp)
    t = t_opt.make_optimizer(hp)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = j.init(jp), t.init(tp)
    for step in range(2):
        grads = _tensors(8 + step)
        jp, js = j.update([jnp.asarray(g) for g in grads], js, jp, 1e-3)
        ts = t.update([torch.from_numpy(g) for g in grads], ts, tp, 1e-3)
    assert ts.step == int(js.step) == 2
    for a, b in zip(tp, jp):
        # One f32 rounding per op in the same formula order.
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
