"""K7a wseg_t (a lane of 8 columns a chunk, the row walk of
csrc/film_rows.cuh; csrc/wseg_common.cuh), K13a wseg (the same body with
row-major weights) and K6a segsum_t (the ranks staged once for all heads,
16-byte loads, runs joined inside a block; csrc/segsum_t.cu) on the card:
each against its plain version within the order bound
(chip_smoke.check_kernel) and against its earlier body
(tools/earlier_designs.py: csrc/wseg_t_walk.cu, csrc/segsum_t_walk.cu)
bit for bit, K7a on every row of at most two 64-edge chunks
(chip_smoke.film_design_check), K6a on every row of at most two 8-edge
runs (chip_smoke.segsum_t_design_check). On the receiver and fine ranks of
a QM9 pack, whose dump rank runs over some hundred chunks: K7a at D 16,
100, 128 and 320 with 1, 4 and 8 heads (16-byte and 2-byte paths, lanes
that straddle heads), on [E, D+K] streams read through d_used (272- and
648-byte rows), on a stream that is not 16-byte aligned, at 96 and 128
heads (opted-in shared memory) and on an empty stream; K13a equal to K7a
on the same weights laid out head-major; K6a on both tables at 1, 8 and 96
heads, with E not a multiple of 4 and a stream that is not 16-byte
aligned (4-byte loads), and on ranks with gaps (outside the kernels'
contract, but they must not write past K6a's row buffer); the wrappers
refuse what the kernels do not take.

Marked `cuda`; every test skips without a GPU. This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_wseg_segsum_t_rows.py
"""

import functools

import pytest
import torch

from chip_smoke import (check_kernel, film_design_check, row_abs_sums,
                        row_counts, seam_rows, segsum_t_design_check)
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.tools import earlier_designs as ed

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def qm9_ranks():
    """The receiver ranks and table height, and the fine ranks and table
    height, of a 10,000-node pack of QM9's validation fold."""
    from tf_gnn_samples_torch.tasks import base, qm9
    task = qm9.QM9_Task(qm9.QM9_Task.default_params())
    data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:700]
    graph = next(task.make_minibatch_iterator(
        data, base.DataFold.VALIDATION, 10000)).graph
    flat = graph.flat
    return {"receiver": (flat.rcv_rank, rs.rank_table_rows(graph.n_pad, 256)),
            "fine": (flat.tgt_rank, flat.fine_to_flat.shape[0])}


def ranks_on(dev, table):
    ranks, rows = qm9_ranks()[table]
    ranks = ranks.to(dev)
    # The pack's padded edges share the dump rank, over many chunks.
    assert bool(seam_rows(torch, ranks, rows).any())
    return ranks, rows


def launched(before):
    return {k: v - before[k] for k, v in rs.LAUNCHES.items()
            if v != before[k]}


def k7a_check(dev, msgs, w_t, ranks, rows, k, d_used=None, name="wseg_t"):
    """K7a against its plain version and its earlier body; one launch
    each."""
    before = dict(rs.LAUNCHES)
    got = rs._wseg_t_impl(msgs, w_t, ranks, table_rows=rows, num_heads=k,
                          d_used=d_used)
    walk = ed.wseg_t_walk(msgs, w_t, ranks, table_rows=rows, num_heads=k,
                          d_used=d_used)
    torch.cuda.synchronize()
    assert launched(before) == {"wseg_t": 1, "wseg_t_walk": 1}
    d = d_used or msgs.shape[1]
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    terms = rs._bf16_terms(msgs[:, :d].float() * rs._head_replicate(w_t, d))
    check_kernel(name, got, rs._wseg_t_plain(msgs, w_t, ranks, rows, d_used),
                 row_abs_sums(torch, rows, ranks, terms),
                 row_counts(torch, rows, ranks), torch)
    film_design_check(torch, name + " = its earlier design's", got, walk,
                      ranks)
    return got


def stream(dev, e, width, seed, misaligned=False):
    """A bf16 [e, width] stream over 2^-8 .. 2^8 (f32 sums of bf16 terms
    of one magnitude would be exact in any order); with `misaligned`, a
    view one element into its storage (rows not 16-byte aligned)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(e * width + 1, generator=gen, device=dev) * torch.exp2(
        torch.randint(-8, 9, (e * width + 1,), generator=gen, device=dev))
    x = x.to(torch.bfloat16)
    return (x[1:] if misaligned else x[:-1]).view(e, width)


def weights(dev, k, e, seed):
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.rand((k, e), generator=gen, device=dev)


@pytest.mark.parametrize("d,k", [(16, 1), (16, 4), (16, 8), (100, 1),
                                 (100, 4), (128, 1), (128, 4), (128, 8),
                                 (320, 1), (320, 4), (320, 8)])
def test_wseg_t_rows_on_qm9_receiver_ranks(dev, d, k):
    """16-byte loads (D a multiple of 8) and 2-byte ones (D 100); lanes
    whose 8 columns straddle heads (Dh 2, 4 and 25)."""
    ranks, rows = ranks_on(dev, "receiver")
    e = ranks.shape[0]
    k7a_check(dev, stream(dev, e, d, d + k), weights(dev, k, e, d + k),
              ranks, rows, k, name="wseg_t D=%d K=%d" % (d, k))


@pytest.mark.parametrize("d,k,extra,misaligned", [
    (128, 8, 8, False),   # the fused branch's [E, D+K]: 272-byte rows
    (320, 4, 4, False),   # at PPI's width: 648-byte rows, the 2-byte path
    (100, 4, 4, False),   # Dh 25 straddling lanes, 208-byte rows
    (128, 8, 0, True),    # a stream that is not 16-byte aligned
])
def test_wseg_t_rows_through_d_used_and_unaligned(dev, d, k, extra,
                                                  misaligned):
    ranks, rows = ranks_on(dev, "receiver")
    e = ranks.shape[0]
    msgs = stream(dev, e, d + extra, d + 3, misaligned)
    assert (msgs.data_ptr() % 16 != 0) == misaligned
    k7a_check(dev, msgs, weights(dev, k, e, d), ranks, rows, k,
              d_used=d if extra else None,
              name="wseg_t D=%d of %d K=%d" % (d, d + extra, k))


@pytest.mark.parametrize("d,k", [(192, 96), (128, 128)])
def test_wseg_t_rows_at_many_heads(dev, d, k):
    """96 and 128 heads: the block's weights take 99 and 165 KB of shared
    memory (opted in above 48 KB); a head of 2 columns and of 1."""
    ranks, rows = ranks_on(dev, "fine")
    e = ranks.shape[0]
    k7a_check(dev, stream(dev, e, d, k), weights(dev, k, e, k), ranks, rows,
              k, name="wseg_t D=%d K=%d (fine ranks)" % (d, k))


def test_wseg_t_empty_stream_launches_nothing(dev):
    ranks = torch.zeros(0, dtype=torch.int32, device=dev)
    before = dict(rs.LAUNCHES)
    out = rs._wseg_t_impl(torch.zeros((0, 64), dtype=torch.bfloat16,
                                      device=dev),
                          torch.zeros((4, 0), device=dev), ranks,
                          table_rows=5, num_heads=4)
    assert out.shape == (5, 64) and not out.any()
    assert launched(before) == {}


@pytest.mark.parametrize("d,k", [(128, 8), (100, 4)])
def test_wseg_rows_match_wseg_t_on_transposed_weights(dev, d, k):
    """K13a takes K7a's body with row-major weights: within its plain
    version's order bound, and equal to K7a on the same weights laid out
    head-major on every row that is not a seam row."""
    ranks, rows = ranks_on(dev, "receiver")
    e = ranks.shape[0]
    msgs, w = stream(dev, e, d, 7), weights(dev, k, e, 7).t().contiguous()
    before = dict(rs.LAUNCHES)
    got = rs._wseg_impl(msgs, w, ranks, table_rows=rows, num_heads=k)
    torch.cuda.synchronize()
    assert launched(before) == {"wseg": 1}
    terms = rs._bf16_terms(msgs.float() * rs._head_replicate(w.t(), d))
    check_kernel("wseg D=%d K=%d" % (d, k), got,
                 rs._wseg_plain(msgs, w, ranks, rows),
                 row_abs_sums(torch, rows, ranks, terms),
                 row_counts(torch, rows, ranks), torch)
    film_design_check(torch, "wseg = wseg_t", got,
                      rs._wseg_t_impl(msgs, w.t().contiguous(), ranks,
                                      table_rows=rows, num_heads=k), ranks)


def k6a_check(dev, m_t, ranks, rows, name):
    before = dict(rs.LAUNCHES)
    got = rs._segsum_t_impl(m_t, ranks, table_rows=rows)
    walk = ed.segsum_t_walk(m_t, ranks, table_rows=rows)
    torch.cuda.synchronize()
    assert launched(before) == {"segsum_t": 1, "segsum_t_walk": 1}
    assert got.dtype == torch.float32 and got.shape == (m_t.shape[0], rows)
    terms = rs._bf16_terms(m_t).t()
    check_kernel(name, got.t(), rs._segsum_t_plain(m_t, ranks, rows).t(),
                 row_abs_sums(torch, rows, ranks, terms),
                 row_counts(torch, rows, ranks), torch)
    segsum_t_design_check(torch, name + " = its earlier design's", got, walk,
                          ranks)


def head_stream(dev, k, e, seed, misaligned=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 3 * torch.randn(k * e + 1, generator=gen, device=dev) * torch.exp2(
        torch.randint(-8, 9, (k * e + 1,), generator=gen, device=dev))
    return (x[1:] if misaligned else x[:-1]).view(k, e)


@pytest.mark.parametrize("k", [1, 8, 96])
@pytest.mark.parametrize("table", ["receiver", "fine"])
def test_segsum_t_rows_on_both_rgat_tables(dev, table, k):
    ranks, rows = ranks_on(dev, table)
    k6a_check(dev, head_stream(dev, k, ranks.shape[0], k), ranks, rows,
              "segsum_t %s K=%d" % (table, k))


@pytest.mark.parametrize("cut,misaligned", [(3, False), (1, False),
                                            (0, True)])
def test_segsum_t_rows_take_4_byte_loads(dev, cut, misaligned):
    """E not a multiple of 4 (the stream cut short by 3 or 1 edges), or a
    stream that is not 16-byte aligned: 4-byte loads."""
    ranks, rows = ranks_on(dev, "receiver")
    ranks = ranks[:ranks.shape[0] - cut]
    m_t = head_stream(dev, 8, ranks.shape[0], 11 + cut, misaligned)
    assert (m_t.data_ptr() % 16 != 0) == misaligned
    k6a_check(dev, m_t, ranks, rows,
              "segsum_t E=%d%s" % (ranks.shape[0],
                                   " unaligned" if misaligned else ""))


def test_segsum_t_rows_on_ranks_with_gaps(dev):
    """Ranks three apart: a 256-edge chunk's rows no longer fit the warp's
    row buffer, so the rows past it go straight to the table, and the rows
    in the gaps stay zero."""
    ranks, rows = ranks_on(dev, "receiver")
    k6a_check(dev, head_stream(dev, 8, ranks.shape[0], 5), 3 * ranks,
              3 * rows, "segsum_t ranks with gaps")


def test_k7a_k6a_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ranks, rows = ranks_on(dev, "receiver")
    e = ranks.shape[0]
    msgs, w_t = stream(dev, e, 64, 1), weights(dev, 4, e, 1)
    m_t = head_stream(dev, 4, e, 1)
    before = dict(rs.LAUNCHES)
    for wseg in (rs._wseg_t_impl, ed.wseg_t_walk):
        call = functools.partial(wseg, table_rows=rows, num_heads=4)
        with pytest.raises(TypeError):  # an f32 stream
            call(msgs.float(), w_t, ranks)
        with pytest.raises(TypeError):  # bf16 weights
            call(msgs, w_t.to(torch.bfloat16), ranks)
        with pytest.raises(TypeError):
            call(msgs, w_t, ranks.long())
        with pytest.raises(ValueError):  # ranks on the CPU
            call(msgs, w_t, ranks.cpu())
        with pytest.raises(ValueError):  # weights that are a column slice
            call(msgs, weights(dev, 4, e + 1, 1)[:, :e], ranks)
        with pytest.raises(ValueError):  # more heads than the wrapper takes
            wseg(msgs.repeat(1, 4), weights(dev, 256, e, 1), ranks,
                 table_rows=rows, num_heads=256)
        with pytest.raises(ValueError):  # 64 columns into 3 heads
            wseg(msgs, weights(dev, 3, e, 1), ranks, table_rows=rows,
                 num_heads=3)
    for segsum in (rs._segsum_t_impl, ed.segsum_t_walk):
        with pytest.raises(TypeError):  # a bf16 stream
            segsum(m_t.to(torch.bfloat16), ranks, table_rows=rows)
        with pytest.raises(TypeError):
            segsum(m_t, ranks.long(), table_rows=rows)
        with pytest.raises(ValueError):  # ranks on the CPU
            segsum(m_t, ranks.cpu(), table_rows=rows)
        with pytest.raises(ValueError):  # a stream that is a column slice
            segsum(head_stream(dev, 4, e + 8, 1)[:, :e], ranks,
                   table_rows=rows)
    assert rs.LAUNCHES == before
