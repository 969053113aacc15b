"""K3 in its gather form (`_film_src_bwd_gather_impl`: gamma|beta, g and t
read through the edges' fine ranks and the src groups' rows, as the fused
FiLM backward calls it) and K4 in its split form (`_film_bwd_split_impl`:
gamma|beta and g apart, as the FiLM aggregation's backward calls it),
against the JAX package on the CPU, and against the port's own stream and
gamma|beta|g forms.

The JAX side builds K3's inputs as its `_ffsp_bwd` does (the gamma|beta|C
table with zero rows appended, gathered per edge; the t rows gathered by
src group) and runs `_film_src_bwd_impl`, and K4 runs `_film_bwd_impl` on
the concatenated table, both Pallas kernels in interpret mode. Streams:
the first 600-node QM9 pack's undiluted src stream and the diluted stream
of a PPI-like graph, whose fill slots carry SD_FILL keys. On the CPU the
port's entries run the plain versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import check_kernel, src_terms
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window

from test_torch_film import TERMS, batches, bf16_pair, i32  # noqa: F401
from test_torch_film_norm import f32, ppi  # noqa: F401


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


def graphs(batches, ppi, which):
    """(JAX GraphBatch, port GraphBatch) of the named stream."""
    return batches if which == "qm9" else ppi


def k3_inputs(jg, tg, d, seed):
    """The same bf16 gamma|beta [RPAD, 2D], g [RPAD, D] and node table t
    [L * n_pad, D] for both packages, and each package's src stream."""
    rng = np.random.RandomState(seed)
    rpad = tg.flat.fine_to_flat.shape[0]
    t_rows = tg.num_edge_types * tg.n_pad
    gb = bf16_pair(rng.randn(rpad, 2 * d).astype(np.float32))
    g = bf16_pair(rng.randn(rpad, d).astype(np.float32))
    t = bf16_pair(rng.randn(t_rows, d).astype(np.float32))
    return gb, g, t, j_layers.src_stream(jg.flat), t_layers.src_stream(tg.flat)


def jax_k3(gb16, g16, fine, t16, src_from_rank, ranks, win, act):
    """K3 as the JAX package's _ffsp_bwd feeds it."""
    d = g16.shape[1]
    table = jnp.concatenate([gb16, gb16[:, :d] * g16], axis=1)
    ext = jnp.concatenate([table, jnp.zeros((8, 3 * d), table.dtype)], 0)
    gcb = jnp.take(ext, jnp.minimum(fine, table.shape[0]), axis=0,
                   mode="clip")
    t_ranked = jnp.take(t16, src_from_rank, axis=0, mode="clip")
    return j_rs._film_src_bwd_impl(
        gcb, t_ranked, ranks, table_rows=src_from_rank.shape[0],
        block_edges=256, act=act, win=win)


@pytest.mark.parametrize("d", [32, 20])
@pytest.mark.parametrize("act", ["relu", "elu", "gelu"])
@pytest.mark.parametrize("which", ["qm9", "diluted"])
def test_gather_k3_matches_pallas(batches, ppi, which, act, d):
    """The gather form against the JAX chain on the undiluted QM9 stream
    and on the diluted PPI-like one (its SD_FILL slots add nothing); D = 32
    and D = 20, no multiple of 8. relu within TERMS. elu' and gelu' go
    through exp (and gelu' through the erf polynomial), which XLA and
    PyTorch evaluate a last f32 bit apart now and then; that can carry a
    term to the neighbouring bf16 number (2^-7 of itself at most: one of
    the 36,160 entries of the diluted stream at D = 20 for elu), so both
    are held to check_kernel's order bound with one bf16 step a term
    (term_ulps=1), as tests/test_torch_film_dgb_split.py holds gelu."""
    jg, tg = graphs(batches, ppi, which)
    (jgb, tgb), (jgg, tgg), (jt, tt), (jf, jr, jw), (tf, tr, _) = k3_inputs(
        jg, tg, d, seed=4)
    sfr = tg.flat.src_from_rank
    if which == "diluted":
        assert bool((tf == int(t_graph.SD_FILL)).any())
    want = jax_k3(jgb, jgg, jf, jt, jg.flat.src_from_rank, jr, jw, act)
    got = t_rs._film_src_bwd_gather_impl(tgb, tgg, tf, tt, sfr, tr,
                                         table_rows=sfr.shape[0], act=act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if act == "relu":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TERMS)
    else:
        rows = sfr.shape[0]
        gcb, t_ranked = t_rs._src_stream_inputs(tgb, tgg, tf, tt, sfr)
        terms = src_terms(torch, t_rs, gcb, t_ranked, tr, act)
        check_kernel("film_src_bwd gather (%s, %s, D=%d)" % (which, act, d),
                     got, torch.from_numpy(np.array(want)),
                     torch.zeros((rows, d)).index_add_(0, tr, terms.abs()),
                     torch.zeros(rows).index_add_(0, tr, torch.ones(len(tr))),
                     torch, term_ulps=1)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


@pytest.mark.parametrize("which", ["qm9", "diluted"])
def test_gather_k3_equals_the_stream_form(batches, ppi, which):
    """The gather form and the stream form on the stream and t rows that
    the fused backward built before: the same table bit for bit; the rows
    that no real edge feeds stay zero."""
    jg, tg = graphs(batches, ppi, which)
    (_, gb), (_, g), (_, t), _, (fine, ranks, _) = k3_inputs(jg, tg, 24, 5)
    sfr = tg.flat.src_from_rank
    rows = sfr.shape[0]
    got = t_rs._film_src_bwd_gather_impl(gb, g, fine, t, sfr, ranks,
                                         table_rows=rows, act="elu")
    gcb, t_ranked = t_rs._src_stream_inputs(gb, g, fine, t, sfr)
    want = t_rs._film_src_bwd_impl(gcb, t_ranked, ranks, table_rows=rows,
                                   act="elu")
    assert torch.equal(got, want)
    fed = torch.zeros(rows, dtype=torch.bool)
    fed[ranks[fine < g.shape[0]].long()] = True
    assert bool((~fed).any()) and not got[~fed].any()


@pytest.mark.parametrize("d", [32, 20])
@pytest.mark.parametrize("act", ["relu", "elu"])
def test_split_k4_matches_pallas(batches, act, d):
    """The split form against _film_bwd_impl on the concatenated table, run
    as tests/test_torch_film_norm.py runs K4: d_gb within TERMS; d_msgs
    bit for bit for relu, within one bf16 step for elu (two libraries'
    exp), and the split form equals the port's gamma|beta|g form exactly."""
    jg, tg = batches
    rng = np.random.RandomState(6)
    ranks = tg.flat.tgt_rank
    e, rpad = ranks.shape[0], tg.flat.fine_to_flat.shape[0]
    jm, tm = bf16_pair(rng.randn(e, d).astype(np.float32))
    jt, tt = bf16_pair(rng.randn(rpad, 3 * d).astype(np.float32))
    jdm, jdgb = j_rs._film_bwd_impl(jm, jt, i32(ranks), block_edges=256,
                                    act=act,
                                    win=token_window(jg.flat.win_fine))
    tdm, tdgb = t_rs._film_bwd_split_impl(
        tm, tt[:, :2 * d].contiguous(), tt[:, 2 * d:].contiguous(), ranks,
        act=act)
    assert tdm.dtype == torch.bfloat16 and tdm.shape == (e, d)
    assert tdgb.dtype == torch.float32 and tdgb.shape == (rpad, 2 * d)
    if act == "relu":
        np.testing.assert_array_equal(f32(tdm), f32(jdm))
    else:
        np.testing.assert_allclose(f32(tdm), f32(jdm), rtol=2 ** -7,
                                   atol=1e-5)
        assert (f32(tdm) != f32(jdm)).mean() < 1e-2
    np.testing.assert_allclose(tdgb.numpy(), np.asarray(jdgb), **TERMS)
    gdm, gdgb = t_rs._film_bwd_impl(tm, tt, ranks, act=act)
    assert torch.equal(tdm, gdm) and torch.equal(tdgb, gdgb)
    assert sum(t_rs.LAUNCHES.values()) == 0


def test_new_wrappers_check_shapes():
    bf = torch.bfloat16
    ranks = torch.zeros(8, dtype=torch.int32)
    gb, g = torch.zeros(5, 8, dtype=bf), torch.zeros(5, 4, dtype=bf)
    t, sfr = torch.zeros(7, 4, dtype=bf), torch.zeros(6, dtype=torch.int32)
    gather = t_rs._film_src_bwd_gather_impl
    gather(gb, g, ranks, t, sfr, ranks, table_rows=6, act="elu")
    with pytest.raises(ValueError):  # g not [RPAD, D]
        gather(gb, torch.zeros(5, 3, dtype=bf), ranks, t, sfr, ranks,
               table_rows=6, act="elu")
    with pytest.raises(ValueError):  # fine ranks not one per edge
        gather(gb, g, ranks[:7], t, sfr, ranks, table_rows=6, act="elu")
    with pytest.raises(ValueError):  # t of another width
        gather(gb, g, ranks, torch.zeros(7, 5, dtype=bf), sfr, ranks,
               table_rows=6, act="elu")
    with pytest.raises(ValueError):  # src_from_rank not [table_rows]
        gather(gb, g, ranks, t, sfr, ranks, table_rows=5, act="elu")
    m = torch.zeros(8, 4, dtype=bf)
    t_rs._film_bwd_split_impl(m, gb, g, ranks, act="elu")
    with pytest.raises(ValueError):
        t_rs._film_bwd_split_impl(m, gb, torch.zeros(6, 4, dtype=bf), ranks,
                                  act="elu")
    with pytest.raises(ValueError):
        t_rs._film_bwd_split_impl(m, gb, torch.zeros(5, 3, dtype=bf), ranks,
                                  act="elu")
    with pytest.raises(ValueError):
        t_rs._film_bwd_split_impl(m, gb, g, ranks[:7], act="elu")
