"""The port's recurrent cells and orthogonal initializer against the JAX
package's: one step of each cell type (keras-TF1 gate order, hard_sigmoid)
with its gradients, cell_init's shapes and LSTM forget bias, and
orthogonal's shape and orthogonality. Inputs come from numpy with a fixed
seed and go to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import cells as j_cells
from tf_gnn_samples_torch.nn import cells as t_cells
from tf_gnn_samples_torch.nn import initializers as t_init

D = 24
N = 50
GATES = {"rnn": 1, "gru": 3, "lstm": 4}


def _cell_inputs(cell_type, seed):
    rng = np.random.RandomState(seed)
    g = GATES[cell_type]
    params = {"kernel": (rng.randn(D, g * D) / np.sqrt(D)).astype(np.float32),
              "recurrent_kernel": (rng.randn(D, g * D) / np.sqrt(D)).astype(
                  np.float32),
              "bias": (0.5 * rng.randn(g * D)).astype(np.float32)}
    x, h, c, w = (rng.randn(N, D).astype(np.float32) for _ in range(4))
    return params, x, h, c, w


@pytest.mark.parametrize("activation", ["tanh", "relu"])
@pytest.mark.parametrize("cell_type,with_c", [
    ("rnn", False), ("gru", False), ("lstm", False), ("lstm", True)])
def test_cell_apply_matches_jax(cell_type, with_c, activation):
    """Output, LSTM cell state and every gradient of one step (the LSTM
    also from a given cell state); f32 matmuls of depth 24 in two
    libraries differ by a few ulps of O(1) values."""
    params, x, h, c, w = _cell_inputs(cell_type, seed=len(cell_type))

    def jloss(p, xx, hh, cc):
        out, new_c = j_cells.cell_apply(p, cell_type, xx, hh, activation,
                                        cc if with_c else None)
        extra = jnp.sum(new_c) if new_c is not None else 0.0
        return jnp.sum(out * w) + extra, (out, new_c)

    (_, (jout, jc)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(params, x, h, c)

    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    tx, th, tc = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (x, h, c))
    out, new_c = t_cells.cell_apply(tp, cell_type, tx, th, activation,
                                    tc if with_c else None)
    loss = (out * torch.from_numpy(w)).sum()
    if new_c is not None:
        loss = loss + new_c.sum()
    loss.backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    assert (new_c is None) == (jc is None)
    if new_c is not None:
        np.testing.assert_allclose(new_c.detach().numpy(), np.asarray(jc),
                                   **tol)
    jp, jx, jh, jcg = jgrads
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jp[k]),
                                   err_msg=k, **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), **tol)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), **tol)
    if with_c:
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jcg), **tol)


@pytest.mark.parametrize("cell_type", ["RNN", "gru", "LSTM"])
def test_cell_init_matches_jax_shapes(cell_type):
    gen = torch.Generator().manual_seed(0)
    got = t_cells.cell_init(gen, cell_type, D)
    want = j_cells.cell_init(jax.random.PRNGKey(0), cell_type, D)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32
    # Zero biases except the keras unit_forget_bias rows of the LSTM.
    np.testing.assert_array_equal(got["bias"].numpy(), np.asarray(want["bias"]))
    with pytest.raises(ValueError):
        t_cells.cell_init(gen, "transformer", D)


@pytest.mark.parametrize("shape", [(16, 48), (48, 16), (32, 32), (2, 8, 12)])
def test_orthogonal_shape_and_orthogonality(shape):
    """Orthonormal rows or columns, whichever side is smaller (the last
    axis holds the columns, as jax.nn.initializers.orthogonal)."""
    gen = torch.Generator().manual_seed(1)
    q = t_init.orthogonal(gen, shape)
    assert tuple(q.shape) == shape and q.dtype == torch.float32
    m = q.reshape(-1, shape[-1]).double()
    gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[0]),
                               atol=1e-5)
    again = t_init.orthogonal(torch.Generator().manual_seed(1), shape)
    assert torch.equal(q, again)
    # Uniform over orthogonal matrices: entries are not all one sign.
    assert 0.2 < float((q > 0).double().mean()) < 0.8
