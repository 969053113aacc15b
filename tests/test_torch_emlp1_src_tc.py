"""The earlier bodies of K14 (emlp1_src_bwd_scalar), K15a
(film_fwd_mask_walk) and K15b (masked_segsum_walk) and the order-free
check of the redesigned K14, on the CPU. Tensors on the CPU take the
kernels' plain versions, so the earlier bodies' wrappers must return the
plain versions' outputs, which tests/test_torch_edge_mlp_fused.py and
tests/test_torch_wseg_mask.py hold against the JAX package's Pallas
kernels in interpret mode (K15a's mask here also at D = 24; K15b's table
here too). chip_smoke.py's emlp1_src_bwd_tc_check, which holds
the tensor-core K14 on the card, accepts the plain version's table on the
multitype graph's src streams (undiluted and diluted);
emlp1_src_bwd_fits says which widths the kernel's block holds, and the
gate sends a forced wider config to the default type-major step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import emlp1_src_bwd_tc_check
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.tools import earlier_designs

from test_torch_edge_mlp import bf16_pair, count_calls
from test_torch_edge_mlp_fused import (interpret, multi,  # noqa: F401
                                       src_pass_inputs)
from test_torch_rgat import assert_order_bound, i32, scatter_abs
from test_torch_wseg_mask import exact_pow2, mask_inputs  # noqa: F401


def _k14_torch_inputs(tg, seed, diluted):
    """src_pass_inputs as the port's bf16 / int32 tensors."""
    ranks, rsrc, gcb, t, w, cols, _, e_real = src_pass_inputs(tg, seed,
                                                              diluted)
    return dict(ranks=ranks, rsrc=rsrc, gcb=bf16_pair(gcb)[1],
                t=bf16_pair(t)[1], w=bf16_pair(w)[1],
                cols=torch.from_numpy(cols),
                e_real=torch.tensor([e_real], dtype=torch.int32))


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("diluted", [False, True])
def test_emlp1_src_bwd_scalar_on_cpu_is_the_plain_version(multi, diluted,
                                                          act):
    """K14's earlier body on CPU tensors: the plain version's table bit for
    bit, no launch; and that table within the order-free check, which the
    redesign is held to on the card."""
    _, tg = multi
    k = _k14_torch_inputs(tg, 3, diluted)
    args = (k["gcb"], k["t"], k["cols"], k["w"], k["e_real"], k["ranks"])
    before = dict(t_rs.LAUNCHES)
    got = earlier_designs.emlp1_src_bwd_scalar(*args, table_rows=k["rsrc"],
                                               act=act)
    want = t_rs._emlp1_src_bwd_plain(*args, k["rsrc"], act)
    assert t_rs.LAUNCHES == before
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(
        t_rs._emlp1_src_bwd_impl(*args, table_rows=k["rsrc"], act=act), want)
    emlp1_src_bwd_tc_check(torch, t_rs, got, want, *args, k["rsrc"], act)


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
@pytest.mark.parametrize("dim", [128, 40, 24])
def test_film_fwd_mask_walk_on_cpu_is_the_plain_version(exact_pow2, act,
                                                        dim):
    """K15a's earlier body on CPU tensors: the plain version's table and
    mask bit for bit, no launch; its mask equals the Pallas kernel's bit
    for bit (D = 24 and 40 fill part of their last 16-column group)."""
    msgs, gb, ranks, _ = mask_inputs(dim, 5 + dim)
    before = dict(t_rs.LAUNCHES)
    table, mask = earlier_designs.film_fwd_mask_walk(msgs, gb, ranks, act=act)
    want_t, want_m = t_rs._film_fwd_mask_plain(msgs, gb, ranks, act)
    assert t_rs.LAUNCHES == before
    assert torch.equal(table, want_t) and torch.equal(mask, want_m)
    assert mask.shape == (ranks.shape[0], t_rs._mask_lanes(dim))
    _, jm = j_rs._film_fwd_mask_impl(
        jnp.asarray(msgs.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16), i32(ranks),
        block_edges=256, act=act)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
@pytest.mark.parametrize("dim", [128, 40])
def test_masked_segsum_walk_on_cpu_is_the_plain_version(interpret,
                                                        exact_pow2, act,
                                                        dim):
    """K15b's earlier body on CPU tensors: the plain version's table bit
    for bit, no launch; within the f32 order bound of the Pallas kernel's
    (interpret mode) over the mask K15a writes and a random C stream."""
    msgs, gb, ranks, rows = mask_inputs(dim, 17 + dim)
    _, mask = t_rs._film_fwd_mask_impl(msgs, gb, ranks, act=act)
    leak = t_rs.MASKABLE_ACTS[act]
    c = torch.from_numpy(np.random.RandomState(dim + 1).randn(
        ranks.shape[0], dim).astype(np.float32)).to(torch.bfloat16)
    before = dict(t_rs.LAUNCHES)
    got = earlier_designs.masked_segsum_walk(mask, c, ranks, table_rows=rows,
                                             leak=leak)
    assert t_rs.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (rows, dim)
    assert torch.equal(got, t_rs._masked_segsum_plain(mask, c, ranks, rows,
                                                      leak))
    want = np.asarray(j_rs._masked_segsum_impl(
        jnp.asarray(mask.numpy()),
        jnp.asarray(c.float().numpy()).astype(jnp.bfloat16), i32(ranks),
        table_rows=rows, block_edges=256, leak=leak))
    bits = t_rs.mask_unpack(mask, dim)
    factor = bits if leak == 0.0 else leak + (1.0 - leak) * bits
    terms = t_rs._bf16_terms(c.float() * factor).numpy()
    assert_order_bound(got.numpy(), want,
                       *scatter_abs(terms, ranks, rows, axis=0))


def test_emlp1_src_bwd_fits_the_gated_widths():
    """K14's block holds the four streamed types' weights up to D = 128
    (QM9's width) and a chunk's rows; wider weights, more types than the
    tile header takes, or none, do not fit."""
    assert t_rs.emlp1_src_bwd_fits(4, 128)
    assert t_rs.emlp1_src_bwd_fits(4, 44) and t_rs.emlp1_src_bwd_fits(1, 128)
    assert t_rs.emlp1_src_bwd_fits(8, 64)
    assert not t_rs.emlp1_src_bwd_fits(4, 144)
    assert not t_rs.emlp1_src_bwd_fits(5, 128)
    assert not t_rs.emlp1_src_bwd_fits(9, 16)
    assert not t_rs.emlp1_src_bwd_fits(0, 16)


@pytest.mark.parametrize("width", [64, 144])
def test_forced_fused_src1_takes_only_widths_the_kernel_holds(
        multi, monkeypatch, width):
    """With ENABLE_EMLP1_SRC_PASS forced on, the type-major layer of four
    streamed types takes the source-order pass (K14's backward) at D 64
    and the default type-major step at D 144, past K14's shared memory,
    so a forced wide config trains and never reaches the wrapper's
    refusal on the card."""
    _, tg = multi
    monkeypatch.setattr(t_rs, "ENABLE_EMLP1_SRC_PASS", True)
    calls = count_calls(monkeypatch, t_rs, "emlp1_tm_pass")
    rng = np.random.RandomState(width)
    num_types = tg.num_edge_types
    params = {
        "edge_mlp": [torch.from_numpy(
            (rng.randn(num_types, a, width) / np.sqrt(a)).astype(np.float32))
            for a in (2 * width, width)],
        "ln": {"scale": torch.ones(width), "bias": torch.zeros(width)}}
    h = torch.from_numpy(rng.randn(tg.n_pad, width).astype(np.float32))
    h.requires_grad_(True)
    out = t_layers.gnn_edge_mlp_apply(
        params, tg, h, activation_function="gelu",
        use_target_state_as_input=True, num_edge_hidden_layers=1,
        typed_edge_scan="auto")
    out.sum().backward()
    assert t_rs.emlp1_src_supported("gelu", width, 4) == (width <= 128)
    assert len(calls) == (width <= 128)
    assert bool(torch.isfinite(h.grad).all())
