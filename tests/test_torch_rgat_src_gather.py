"""K9 in its gather form (`_rgat_src_bwd_gather_impl`: each edge's dagg |
lt | den | cor row read from the side table at its fine key, as the fused
RGAT backward calls it), on the CPU, where the port's wrapper runs the
plain version: equal to the stream form on the [E, D + 3K] stream that
the fused backward built before (the side table with zero rows appended,
gathered at the clamped fine keys), and against the JAX package's
`_rgat_src_bwd_impl` on that stream in interpret mode. Streams: the first
600-node QM9 pack's undiluted src stream and the diluted stream of a
PPI-like graph, whose fill slots carry SD_FILL keys; D 64 and 128 with 8
heads, and D 320 with 4 heads (PPI's hidden size at RGAT's default heads:
rows of 332 and 324 values, not 16-byte aligned)."""

import numpy as np
import pytest
import torch

from tf_gnn_samples_torch.ops import graph as t_graph
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window

from test_torch_rgat_fused import bf16_pair, bf16_round, i32, ppi, qm9  # noqa: F401


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


def gather_inputs(tg, k, dim, seed, diluted):
    """The side table (f32 values on the bf16 grid, [RPAD, D + 3K]: a
    cotangent, target logits with a few beyond the clamp at 50, a positive
    denominator and a correction, the dump and slack rows zero), each
    slot's fine key, the stream the fused backward built from them (zero
    rows appended, keys clamped onto the first), a random t | lsrc table
    in src-rank order, the src ranks and the table height."""
    flat = tg.flat
    rng = np.random.RandomState(seed)
    rpad, rsrc = flat.fine_to_flat.shape[0], flat.src_from_rank.shape[0]
    fine, ranks = ((flat.sd_fine, flat.sd_rank) if diluted
                   else (flat.fine_rank_by_src, flat.src_sorted_rank))
    side = rng.randn(rpad, dim + 3 * k).astype(np.float32)
    side[:, dim:dim + k] *= 2.0
    side[:, dim + k:dim + 2 * k] = 0.5 + 4 * rng.rand(rpad, k)
    side[::37, dim:dim + k] = 80.0
    side[5::41, dim:dim + k] = -400.0
    side[int(flat.tgt_rank.max()):] = 0.0
    side = bf16_round(side)
    stream = np.concatenate([side, np.zeros((8, dim + 3 * k), np.float32)])[
        np.minimum(fine.numpy(), rpad)]
    t_ext = rng.randn(rsrc, dim + k).astype(np.float32)
    return side, fine, stream, t_ext, ranks, rsrc


CASES = [("qm9", False, 8, 64), ("qm9", False, 8, 128), ("ppi", True, 8, 64),
         ("ppi", True, 8, 128), ("ppi", True, 4, 320), ("qm9", False, 4, 320)]


@pytest.mark.parametrize("graph_name,diluted,k,dim", CASES)
def test_rgat_src_bwd_gather_form_matches_stream_form_and_pallas(
        qm9, ppi, graph_name, diluted, k, dim):
    """The gather form equals the stream form bit for bit (fill keys read
    nothing and add zeros, as the appended zero row did), and both lie
    within tests/test_torch_rgat_fused.py's bound of the JAX kernel: per
    row 2^-7 + 1e-5 of sum|term| (two libraries' exp and division, an ulp
    apart, may carry a term to the neighbouring bf16 number; the f32 sum
    order)."""
    tg = qm9[3].graph if graph_name == "qm9" else ppi[1]
    jgraph = qm9[2].graph if graph_name == "qm9" else ppi[0]
    side, fine, stream, t_ext, ranks, rsrc = gather_inputs(
        tg, k, dim, seed=dim + k, diluted=diluted)
    if diluted:
        assert bool((fine == int(t_graph.SD_FILL)).any())
    (_, tside), (jgcb, tgcb), (jt, tt) = (bf16_pair(side), bf16_pair(stream),
                                          bf16_pair(t_ext))
    got = t_rs._rgat_src_bwd_gather_impl(tside, fine, tt, ranks,
                                         table_rows=rsrc, num_heads=k,
                                         clamp=50.0)
    assert got.dtype == torch.float32 and got.shape == (rsrc, dim + k)
    stream_form = t_rs._rgat_src_bwd_impl(tgcb, tt, ranks, table_rows=rsrc,
                                          num_heads=k, clamp=50.0)
    assert torch.equal(got, stream_form)
    win = token_window(jgraph.flat.win_sd if diluted
                       else jgraph.flat.win_src)
    want = np.asarray(j_rs._rgat_src_bwd_impl(
        jgcb, jt, i32(ranks), table_rows=rsrc, num_heads=k, block_edges=256,
        clamp=50.0, win=win))
    e = ranks.shape[0]
    per_edge = t_rs._rgat_src_bwd_plain(
        tgcb, tt.index_select(0, ranks.long()),
        torch.arange(e, dtype=torch.int32), e, k, 50.0).numpy()
    terms_abs = np.zeros((rsrc, dim + k))
    np.add.at(terms_abs, ranks.numpy(), np.abs(per_edge))
    err = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    bound = (2.0 ** -7 + 1e-5) * terms_abs + 1e-30
    assert (err <= bound).all(), float((err / bound).max())
    fed = np.zeros(rsrc, bool)
    fed[ranks.numpy()[(tgcb.float().abs().sum(1) > 0).numpy()]] = True
    assert (~fed).any() and (got.numpy()[~fed] == 0).all()
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions
    assert sum(t_rs.FORM_LAUNCHES.values()) == 0


def test_rgat_src_bwd_gather_checks_its_arguments():
    bf = dict(dtype=torch.bfloat16)
    ranks = torch.zeros(8, dtype=torch.int32)
    keys = torch.tensor([0, 1, 2, 4, 5, -1, 2 ** 31 - 1, 3],
                        dtype=torch.int32)
    side, t_ext = torch.ones(5, 16 + 12, **bf), torch.ones(6, 16 + 4, **bf)
    gather = t_rs._rgat_src_bwd_gather_impl
    out = gather(side, keys, t_ext, ranks, table_rows=6, num_heads=4,
                 clamp=50.0)
    assert out.shape == (6, 20) and out.dtype == torch.float32
    # keys 5, -1 and SD_FILL lie outside the 5-row table: zero rows.
    rows = t_rs._side_rows(side, keys)
    assert rows.shape == (8, 28) and not rows[[4, 5, 6]].any()
    assert bool((rows[[0, 1, 2, 3, 7]] == 1).all())
    with pytest.raises(ValueError):  # the side table is not D + 3K wide
        gather(torch.zeros(5, 24, **bf), keys, t_ext, ranks, table_rows=6,
               num_heads=4, clamp=50.0)
    with pytest.raises(ValueError):  # keys not one per edge
        gather(side, keys[:7], t_ext, ranks, table_rows=6, num_heads=4,
               clamp=50.0)
    with pytest.raises(ValueError):  # the t table is not table_rows high
        gather(side, keys, t_ext, ranks, table_rows=7, num_heads=4,
               clamp=50.0)
    with pytest.raises(ValueError):  # 16 columns do not split into 3 heads
        gather(torch.zeros(5, 16 + 9, **bf), keys, torch.zeros(6, 19, **bf),
               ranks, table_rows=6, num_heads=3, clamp=50.0)
