"""K2 from two tables (`_film_bwd_dgb_split_impl`: gamma|beta and g
apart, as the fused FiLM backward passes them) against the JAX package's
`_film_bwd_dgb_impl` (the Pallas kernel in interpret mode) on a small QM9
batch's real fine ranks, and against the port's own gamma|beta|g form on
gap-free and gapped ranks. On the CPU both port entries run the plain
version."""

import numpy as np
import pytest
import torch

from chip_smoke import check_kernel, film_terms, row_abs_sums, row_counts
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window

from test_torch_film import TERMS, batches, bf16_pair, i32  # noqa: F401


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


def split_tables(gbg, d):
    """gamma|beta [R, 2D] and g [R, D] as two tensors of their own."""
    return gbg[:, :2 * d].contiguous(), gbg[:, 2 * d:].contiguous()


@pytest.mark.parametrize("d", [32, 20])
@pytest.mark.parametrize("act", ["elu", "gelu"])
def test_split_k2_matches_pallas(batches, act, d):
    """The batch's gap-free fine ranks; D = 32 is test_torch_film.py's
    width, D = 20 one that is no multiple of 8. elu within TERMS. gelu's
    derivative goes through exp and the erf approximation, which XLA and
    PyTorch evaluate a last f32 bit apart now and then, so a term near a
    bf16 rounding boundary can round to the neighbouring bf16 value (2^-7
    of itself at most): gelu is held to chip_smoke.check_kernel's order
    bound with one bf16 step a term (term_ulps=1), as the card's K9 is."""
    jg, tg = batches
    rng = np.random.RandomState(2)
    e = tg.flat.tgt_rank.shape[0]
    rpad = tg.flat.fine_to_flat.shape[0]
    (jm, tm), (jt, tt) = (bf16_pair(rng.randn(e, d).astype(np.float32)),
                          bf16_pair(rng.randn(rpad, 3 * d).astype(np.float32)))
    want = j_rs._film_bwd_dgb_impl(jm, jt, i32(tg.flat.tgt_rank),
                                   block_edges=256, act=act,
                                   win=token_window(jg.flat.win_fine))
    got = t_rs._film_bwd_dgb_split_impl(tm, *split_tables(tt, d),
                                        tg.flat.tgt_rank, act=act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if act == "elu":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TERMS)
    else:
        ranks = tg.flat.tgt_rank
        terms = film_terms(torch, t_rs, tm, tt, ranks, act)
        check_kernel("film_bwd_dgb split (%s, D=%d)" % (act, d), got,
                     torch.from_numpy(np.array(want)),
                     row_abs_sums(torch, rpad, ranks, terms),
                     row_counts(torch, rpad, ranks), torch, term_ulps=1)


@pytest.mark.parametrize("gaps", [False, True])
@pytest.mark.parametrize("d", [32, 20])
def test_split_k2_equals_the_gbg_form(batches, d, gaps):
    """The split entry and the gamma|beta|g entry give the same table bit
    for bit, also on ranks with gaps (every other rank unused; the JAX
    kernel's rank window is not made for gaps, so the port is held to
    itself there), whose unused rows stay zero."""
    _, tg = batches
    rng = np.random.RandomState(3)
    ranks = tg.flat.tgt_rank * (2 if gaps else 1)
    rows = int(ranks[-1]) + 3
    msgs = torch.from_numpy(rng.randn(ranks.shape[0], d).astype(
        np.float32)).to(torch.bfloat16)
    gbg = torch.from_numpy(rng.randn(rows, 3 * d).astype(np.float32)).to(
        torch.bfloat16)
    got = t_rs._film_bwd_dgb_split_impl(msgs, *split_tables(gbg, d), ranks,
                                        act="elu")
    want = t_rs._film_bwd_dgb_impl(msgs, gbg, ranks, act="elu")
    assert torch.equal(got, want)
    empty = torch.ones(rows, dtype=torch.bool)
    empty[ranks.long()] = False
    assert bool(empty.any()) and not got[empty].any()
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


def test_split_k2_checks_shapes():
    m = torch.zeros(8, 4, dtype=torch.bfloat16)
    ranks = torch.zeros(8, dtype=torch.int32)
    gb = torch.zeros(5, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        t_rs._film_bwd_dgb_split_impl(m, gb, torch.zeros(
            5, 3, dtype=torch.bfloat16), ranks, act="elu")
    with pytest.raises(ValueError):
        t_rs._film_bwd_dgb_split_impl(m, gb, torch.zeros(
            6, 4, dtype=torch.bfloat16), ranks, act="elu")
