"""The plain versions of K13 (the per-head weighted segment-sum with
row-major [E, K] weights, forward and backward) and K15 (the FiLM forward
that also writes the packed sign mask, and the masked segment-sum) against
the JAX package's Pallas kernels in interpret mode, on the CPU: the
autograd Function against the JAX custom_vjp, and the port's mask unpack
against JAX's pack. No model path of either package calls these ops."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_torch.ops import ranked_segment as t_rs

from test_torch_rgat import (assert_order_bound, bf16_terms, i32,
                             random_stream, scatter_abs)


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


def _pow2(k):
    """2^k as f32 for int32 k in [0, 16), exactly."""
    return jnp.left_shift(jnp.int32(1), k).astype(jnp.float32)


def _exact_pack_matrix(d):
    """j_rs._mask_pack_matrix with exact powers of two (see exact_pow2)."""
    lanes = j_rs._mask_lanes(d)
    j = jax.lax.broadcasted_iota(jnp.int32, (d, lanes), 0)
    g = jax.lax.broadcasted_iota(jnp.int32, (d, lanes), 1)
    return jnp.where(j // 16 == g, _pow2(j % 16), 0.0)


def _exact_unpack(packed_f, d):
    """j_rs._mask_unpack with exact powers of two (see exact_pow2)."""
    lanes = packed_f.shape[1]
    g = jax.lax.broadcasted_iota(jnp.int32, (lanes, d), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (lanes, d), 1)
    rep = jnp.where(j // 16 == g, 1.0, 0.0)
    v = jnp.dot(packed_f, rep, preferred_element_type=jnp.float32)
    shift = 1.0 / _pow2(jax.lax.broadcasted_iota(
        jnp.int32, (packed_f.shape[0], d), 1) % 16)
    t = jnp.floor(v * shift)
    return t - 2.0 * jnp.floor(t * 0.5)


@pytest.fixture
def exact_pow2(monkeypatch):
    """The JAX package builds its mask pack and unpack from jnp.exp2 at
    integer arguments, which XLA:CPU evaluates inexactly (exp2(13) =
    8192.004, exp2(15) = 32767.984): on the CPU its packed lanes miss the
    integers by up to 2^-6 and its unpack flips bits. Its kernels are held
    here with the same formulas on exact powers of two, the packed layout
    the kernels' contract names (test_mask_pack_and_unpack_match_jax
    holds JAX's own pack to it, after rounding)."""
    monkeypatch.setattr(j_rs, "_mask_pack_matrix", _exact_pack_matrix)
    monkeypatch.setattr(j_rs, "_mask_unpack", _exact_unpack)
    for fn in (j_rs._film_fwd_mask_impl, j_rs._masked_segsum_impl):
        fn.clear_cache()
    yield
    for fn in (j_rs._film_fwd_mask_impl, j_rs._masked_segsum_impl):
        fn.clear_cache()


def bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("k,dim", [(8, 128), (4, 64)])
def test_wseg_plain_matches_pallas(k, dim):
    """K13a: m * rep(w) in f32, rounded to bf16, summed in f32 per rank, on
    a 4,096-edge stream with a padded tail: within the f32 order bound,
    exactly for entries of a single term."""
    ranks, rows, _ = random_stream(dim + k)
    rng = np.random.RandomState(dim)
    e = ranks.shape[0]
    m = rng.randn(e, dim).astype(np.float32)
    w = rng.rand(e, k).astype(np.float32)
    want = np.asarray(j_rs._wseg_impl(
        jnp.asarray(m).astype(jnp.bfloat16), jnp.asarray(w), i32(ranks),
        table_rows=rows, num_heads=k, block_edges=256))
    tm = bf16(m)
    got = t_rs._wseg_impl(tm, torch.from_numpy(w), ranks, table_rows=rows,
                          num_heads=k)
    assert got.dtype == torch.float32 and got.shape == (rows, dim)
    terms = bf16_terms(tm.float().numpy() * np.repeat(w, dim // k, axis=1))
    assert assert_order_bound(got.numpy(), want,
                              *scatter_abs(terms, ranks, rows, axis=0))
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


@pytest.mark.parametrize("k,dim", [(8, 128), (4, 64)])
def test_wseg_bwd_plain_matches_pallas(k, dim):
    """K13b: d_msgs = bf16(g[rank] * rep(w)) exactly; d_w, an f32 sum of
    D / K exact products in two orders, within 1e-5 of the largest."""
    ranks, rows, _ = random_stream(dim * k)
    rng = np.random.RandomState(dim * k)
    e = ranks.shape[0]
    m = rng.randn(e, dim).astype(np.float32)
    w = rng.rand(e, k).astype(np.float32)
    g = rng.randn(rows, dim).astype(np.float32)
    jdm, jdw = j_rs._wseg_bwd_impl(
        jnp.asarray(m).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(g).astype(jnp.bfloat16), i32(ranks), num_heads=k,
        block_edges=256)
    tdm, tdw = t_rs._wseg_bwd_impl(bf16(m), torch.from_numpy(w), bf16(g),
                                   ranks, num_heads=k)
    assert tdm.dtype == torch.bfloat16 and tdm.shape == (e, dim)
    assert tdw.dtype == torch.float32 and tdw.shape == (e, k)
    np.testing.assert_array_equal(tdm.float().numpy(),
                                  np.asarray(jdm.astype(jnp.float32)))
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jdw).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_segment_sum_vjp_matches_jax(dtype):
    """ranked_weighted_segment_sum (the autograd Function over K13a / K13b)
    against the JAX custom_vjp under a sum of squares, for an f32 and a
    bf16 stream: the loss within 1e-5; d_msgs in the stream's dtype equal
    to JAX's up to the table cotangent's bf16 rounding, which an f32
    sum-order difference of the table can flip (2^-8 relative, on under 1 %
    of the entries); d_w within 1e-3 (the K7 Function's limits)."""
    ranks, rows, _ = random_stream(41)
    rng = np.random.RandomState(41)
    e, d, k = ranks.shape[0], 64, 4
    m = rng.randn(e, d).astype(np.float32)
    w = rng.rand(e, k).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(mm, ww):
        return jnp.sum(j_rs.ranked_weighted_segment_sum(
            mm, ww, i32(ranks), rows, k, 256) ** 2)

    jval, (jgm, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(m).astype(jdt), jnp.asarray(w))
    tm = torch.from_numpy(m).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tval = (t_rs.ranked_weighted_segment_sum(tm, tw, ranks, rows, k)
            ** 2).sum()
    tgm, tgw = torch.autograd.grad(tval, (tm, tw))
    assert tgm.dtype == tdt and tgw.dtype == torch.float32
    assert tgw.shape == (e, k)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    jgm = np.asarray(jgm.astype(jnp.float32))
    np.testing.assert_allclose(tgm.float().numpy(), jgm, rtol=2 ** -7,
                               atol=1e-6)
    assert (tgm.float().numpy() != jgm).mean() < 1e-2
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), rtol=1e-3,
                               atol=1e-3 * float(np.abs(jgw).max()))


def mask_inputs(dim, seed):
    """A 4,096-edge stream with a padded tail, bf16 messages and a bf16
    gamma | beta table of unit normals (z takes both signs)."""
    ranks, rows, _ = random_stream(seed)
    rng = np.random.RandomState(seed)
    e = ranks.shape[0]
    return (bf16(rng.randn(e, dim).astype(np.float32)),
            bf16(rng.randn(rows, 2 * dim).astype(np.float32)), ranks, rows)


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
@pytest.mark.parametrize("dim", [128, 40])
def test_film_fwd_mask_plain_matches_pallas(exact_pow2, act, dim):
    """K15a: the packed mask equals the Pallas kernel's bit for bit (D = 40
    fills 3 of its 32 lanes, the last one part-way); the table is K1's
    within the f32 order bound."""
    msgs, gb, ranks, rows = mask_inputs(dim, 7 + dim)
    jt, jm = j_rs._film_fwd_mask_impl(
        jnp.asarray(msgs.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16), i32(ranks),
        block_edges=256, act=act)
    tt, tm = t_rs._film_fwd_mask_impl(msgs, gb, ranks, act=act)
    lanes = t_rs._mask_lanes(dim)
    assert lanes == j_rs._mask_lanes(dim) == 32
    assert tm.dtype == torch.float32 and tm.shape == (ranks.shape[0], lanes)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tm[:, -(-dim // 16):] == 0).all() and tm.max() > 2 ** 14
    np.testing.assert_array_equal(
        tt.numpy(), t_rs._film_fwd_plain(msgs, gb, ranks, act).numpy())
    g = gb.float().index_select(0, ranks)
    terms = t_rs._bf16_terms(t_rs._ACTS[act][0](
        g[:, :dim] * msgs.float() + g[:, dim:])).numpy()
    assert_order_bound(tt.numpy(), np.asarray(jt),
                       *scatter_abs(terms, ranks, rows, axis=0))


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
@pytest.mark.parametrize("dim", [128, 40])
def test_masked_segsum_plain_matches_pallas(exact_pow2, act, dim):
    """K15b: bf16(C * factor(mask)) summed in f32 per rank, factor = mask
    (relu) or 0.2 + 0.8 mask (leaky_relu), over the mask K15a writes and a
    random C stream: within the f32 order bound of the Pallas kernel's."""
    msgs, gb, ranks, rows = mask_inputs(dim, 11 + dim)
    _, mask = t_rs._film_fwd_mask_impl(msgs, gb, ranks, act=act)
    leak = t_rs.MASKABLE_ACTS[act]
    assert leak == j_rs.MASKABLE_ACTS[act]
    c = bf16(np.random.RandomState(dim).randn(ranks.shape[0], dim).astype(
        np.float32))
    want = np.asarray(j_rs._masked_segsum_impl(
        jnp.asarray(mask.numpy()),
        jnp.asarray(c.float().numpy()).astype(jnp.bfloat16), i32(ranks),
        table_rows=rows, block_edges=256, leak=leak))
    got = t_rs._masked_segsum_impl(mask, c, ranks, table_rows=rows, leak=leak)
    assert got.dtype == torch.float32 and got.shape == (rows, dim)
    bits = t_rs.mask_unpack(mask, dim)
    factor = bits if leak == 0.0 else leak + (1.0 - leak) * bits
    terms = t_rs._bf16_terms(c.float() * factor).numpy()
    assert_order_bound(got.numpy(), want,
                       *scatter_abs(terms, ranks, rows, axis=0))


@pytest.mark.parametrize("dim", [128, 40])
def test_mask_pack_and_unpack_match_jax(dim):
    """The port's pack equals JAX's _mask_pack_matrix product, rounded to
    the nearest integer (XLA:CPU's inexact exp2 leaves it up to 2^-6 off,
    see exact_pow2), and exactly with exact powers of two; the port's
    unpack inverts it, as JAX's _mask_unpack (exact powers) does the
    port's pack."""
    bits = np.random.RandomState(dim).rand(512, dim) > 0.5
    b32 = jnp.asarray(bits, jnp.float32)
    j_packed = np.asarray(jnp.dot(b32, j_rs._mask_pack_matrix(dim)))
    assert np.abs(j_packed - np.rint(j_packed)).max() <= 2 ** -6
    t_packed = t_rs._mask_pack(torch.from_numpy(bits))
    np.testing.assert_array_equal(t_packed.numpy(), np.rint(j_packed))
    np.testing.assert_array_equal(
        t_packed.numpy(), np.asarray(jnp.dot(b32, _exact_pack_matrix(dim))))
    np.testing.assert_array_equal(
        t_rs.mask_unpack(t_packed, dim).numpy(), bits)
    np.testing.assert_array_equal(
        np.asarray(_exact_unpack(jnp.asarray(t_packed.numpy()), dim)), bits)


def test_k13_k15_wrappers_check_shapes():
    ranks = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):  # head-major weights
        t_rs._wseg_impl(torch.zeros(8, 16), torch.zeros(4, 8), ranks,
                        table_rows=4, num_heads=4)
    with pytest.raises(ValueError):  # 16 columns do not split into 3 heads
        t_rs._wseg_impl(torch.zeros(8, 16), torch.zeros(8, 3), ranks,
                        table_rows=4, num_heads=3)
    with pytest.raises(ValueError):  # g table of another width
        t_rs._wseg_bwd_impl(torch.zeros(8, 16), torch.zeros(8, 4),
                            torch.zeros(4, 32), ranks, num_heads=4)
    with pytest.raises(ValueError):  # gamma | beta of another width
        t_rs._film_fwd_mask_impl(torch.zeros(8, 16), torch.zeros(4, 16),
                                 ranks, act="relu")
    with pytest.raises(ValueError):  # two lanes hold 32 of 48 columns
        t_rs._masked_segsum_impl(torch.zeros(8, 2), torch.zeros(8, 48),
                                 ranks, table_rows=4, leak=0.0)
