"""K1 film_fwd and K2 film_bwd_dgb in their Hopper design
(csrc/film_rows.cuh) on the card: each against its plain version within
the order bound (chip_smoke.check_kernel) and against its earlier design
(csrc/film_walk.cuh, the K16 v3 variants at group 1) bit for bit on every
row of at most two 64-edge chunks (chip_smoke.film_design_check), on a
QM9 batch's real fine ranks for every activation, and on gapped ranks, a
rank run over 1,000 edges and an E that is no multiple of 64, for D in
16, 100, 128 and 320 (16-byte and 2-byte accesses); the split-table K2
against its gamma|beta|g form, also with a g table of another row
stride; the wrappers' refusals.

Marked `cuda`; every test skips without a GPU. This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_film_rows.py
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (check_kernel, film_design_check, film_terms,
                        row_abs_sums, row_counts)
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.tools import film_fwd_ab as ffa

pytestmark = pytest.mark.cuda

WIDTHS = [16, 100, 128, 320]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def stream(kind):
    """Nondecreasing int32 ranks [E] and the table height: "qm9", the fine
    ranks of a 10,000-node pack of QM9's validation fold; "gapped", every
    third rank used; "long_run", a rank over 1,000 edges among short ones;
    "ragged", E = 3,237 (50 chunks and 37 edges)."""
    rng = np.random.RandomState(0)
    if kind == "qm9":
        from tf_gnn_samples_torch.tasks import base, qm9
        task = qm9.QM9_Task(qm9.QM9_Task.default_params())
        data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:700]
        graph = next(task.make_minibatch_iterator(
            data, base.DataFold.VALIDATION, 10000)).graph
        return graph.flat.tgt_rank.numpy(), graph.flat.fine_to_flat.shape[0]
    if kind == "gapped":
        ranks = 3 * ffa.make_stream(4096, 1500)
    elif kind == "long_run":
        ranks = np.repeat(np.arange(342, dtype=np.int32),
                          [5] * 40 + [1000] + [3] * 301)
    else:
        ranks = ffa.make_stream(3237, 1400)
    return ranks, int(ranks[-1]) + 5


def inputs(dev, kind, d, width):
    """bf16 messages [E, d], a bf16 table [rows, width * d] and the ranks
    on the card."""
    ranks, rows = stream(kind)
    ranks = torch.from_numpy(np.asarray(ranks, np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(d)

    def randn(*shape):
        return (2 * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)

    return randn(ranks.shape[0], d), randn(rows, width * d), ranks


def earlier(half, msgs, table, ranks, act):
    """The earlier design of K1 / K2 (the K16 v3 variant at group 1),
    launched past the harness's multiple-of-2,048 check."""
    if half == "fwd":
        return ffa._launch("film_fwd_ab", "film_fwd_v3", 0, msgs, table,
                           ranks, 1, act, 1)
    return ffa._launch("film_dgb_ab", "film_dgb_v3", 0, msgs, table, ranks,
                       2, act, 1)


def check(half, kind, act, d, dev):
    msgs, table, ranks = inputs(dev, kind, d, 2 if half == "fwd" else 3)
    rows = table.shape[0]
    counter = "film_fwd" if half == "fwd" else "film_bwd_dgb"
    before = rs.LAUNCHES[counter]
    if half == "fwd":
        got = rs._film_fwd_impl(msgs, table, ranks, act=act)
        want = rs._film_fwd_plain(msgs, table, ranks, act)
    else:
        got = rs._film_bwd_dgb_impl(msgs, table, ranks, act=act)
        want = rs._film_bwd_dgb_plain(msgs, table, ranks, act)
    torch.cuda.synchronize()
    assert rs.LAUNCHES[counter] == before + 1
    name = "%s %s D=%d %s" % (counter, kind, d, act)
    terms = film_terms(torch, rs, msgs, table, ranks, act)
    check_kernel(name, got, want, row_abs_sums(torch, rows, ranks, terms),
                 row_counts(torch, rows, ranks), torch)
    film_design_check(torch, name, got,
                      earlier(half, msgs, table, ranks, act), ranks)
    empty = torch.ones(rows, dtype=torch.bool, device=dev)
    empty[ranks.long()] = False
    assert int(empty.sum()) > 0 and not got[empty].any()


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("act", sorted(rs.ACT_IDS))
@pytest.mark.parametrize("half", ["fwd", "dgb"])
def test_film_rows_on_qm9_ranks(dev, half, act, d):
    check(half, "qm9", act, d, dev)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", ["gapped", "long_run", "ragged"])
@pytest.mark.parametrize("half", ["fwd", "dgb"])
def test_film_rows_on_other_streams(dev, half, kind, d):
    check(half, kind, "elu", d, dev)


@pytest.mark.parametrize("g_pad", [0, 8])
@pytest.mark.parametrize("d", [100, 128])
@pytest.mark.parametrize("kind", ["qm9", "gapped"])
def test_split_k2_equals_its_gbg_form(dev, kind, d, g_pad):
    """K2 from gamma|beta and g apart (g_pad 8: g a view of a wider
    table, so its rows are 8 elements longer) against K2 from the one
    gamma|beta|g table (two views of it): the same sums in the same order,
    so equal on every row of at most two chunks, and within the order
    bound of the plain version everywhere."""
    msgs, gbg, ranks = inputs(dev, kind, d, 3)
    rows = gbg.shape[0]
    g_wide = torch.zeros((rows, d + g_pad), dtype=torch.bfloat16, device=dev)
    g_wide[:, :d] = gbg[:, 2 * d:]
    gb, g = gbg[:, :2 * d].contiguous(), g_wide[:, :d]
    got = rs._film_bwd_dgb_split_impl(msgs, gb, g, ranks, act="elu")
    torch.cuda.synchronize()
    film_design_check(torch, "film_bwd_dgb split", got,
                      rs._film_bwd_dgb_impl(msgs, gbg, ranks, act="elu"),
                      ranks)
    terms = film_terms(torch, rs, msgs, gbg, ranks, "elu")
    check_kernel("film_bwd_dgb split", got,
                 rs._film_bwd_dgb_plain(msgs, gbg, ranks, "elu"),
                 row_abs_sums(torch, rows, ranks, terms),
                 row_counts(torch, rows, ranks), torch)


def test_k1_k2_wrappers_refuse_what_the_kernels_do_not_take(dev):
    msgs, gbg, ranks = inputs(dev, "ragged", 64, 3)
    gb, g = gbg[:, :128].contiguous(), gbg[:, 128:].contiguous()
    with pytest.raises(TypeError):
        rs._film_fwd_impl(msgs.float(), gb, ranks, act="elu")
    with pytest.raises(TypeError):
        rs._film_fwd_impl(msgs, gb, ranks.long(), act="elu")
    with pytest.raises(ValueError):
        rs._film_fwd_impl(msgs.t().contiguous().t(), gb, ranks, act="elu")
    with pytest.raises(ValueError):
        rs._film_fwd_impl(msgs, gb.cpu(), ranks, act="elu")
    split = functools.partial(rs._film_bwd_dgb_split_impl, act="elu")
    with pytest.raises(TypeError):
        split(msgs, gb, g.float(), ranks)
    with pytest.raises(TypeError):
        split(msgs, gb, g, ranks.long())
    with pytest.raises(ValueError):  # columns not contiguous
        split(msgs, gb, g.t().contiguous().t(), ranks)
    with pytest.raises(ValueError):
        split(msgs, gb, g.cpu(), ranks)
    with pytest.raises(ValueError):
        split(msgs, gb, g[:, :32], ranks)
    with pytest.raises(TypeError):
        rs._film_bwd_dgb_impl(msgs, gbg.float(), ranks, act="elu")
