"""K15b masked_segsum (csrc/masked_segsum.cu: K1's row walk of
csrc/film_rows.cuh, every row of the table written exactly once, no zero
fill and no atomics; the rows that cross a 64-edge chunk joined from the
chunks' partials in chunk order) on the card: against its plain version
within the order bound (chip_smoke.check_kernel) and against its earlier
body (tools/earlier_designs.py: csrc/masked_segsum_walk.cu) bit for bit on
every row of at most two chunks, within the order bound on the rest
(chip_smoke.masked_segsum_design_check). On the src ranks of a QM9 pack
(its padded tail one run over some hundred chunks) at D 16, 24, 100, 128
and 320 (16-byte and 2-byte paths, a pad lane where ceil(D / 8) is odd),
on a 1,000-edge run, on gapped ranks starting past 0, at E 3,237, on a
stream that is not 16-byte aligned and on the diluted src stream; raw
launches into NaN-filled tables write every row, zeros where no edge
reaches, the same bits twice (chip_smoke.masked_segsum_table_check); the
wrapper refuses what the kernel does not take.

Marked `cuda`; every test skips without a GPU. This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_masked_segsum_rows.py
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (check_kernel, masked_segsum_design_check,
                        masked_segsum_nan_tables, masked_segsum_table_check,
                        masked_terms, row_abs_sums, row_counts, seam_rows)
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.tools import earlier_designs as ed

pytestmark = pytest.mark.cuda

LEAKS = sorted(rs.MASKABLE_ACTS.items())


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def qm9_src_ranks():
    """The src-sorted ranks and src-rank table height of a 10,000-node
    pack of QM9's validation fold."""
    from tf_gnn_samples_torch.tasks import base, qm9
    task = qm9.QM9_Task(qm9.QM9_Task.default_params())
    data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:700]
    flat = next(task.make_minibatch_iterator(
        data, base.DataFold.VALIDATION, 10000)).graph.flat
    return flat.src_sorted_rank, flat.src_from_rank.shape[0]


def launched(before):
    return {k: v - before[k] for k, v in rs.LAUNCHES.items()
            if v != before[k]}


def inputs(dev, e, d, seed, misaligned=False):
    """A random packed mask over the ceil(D / 16) used lanes (the rest 0,
    as K15a writes them) and a bf16 C stream over 2^-8 .. 2^8 (f32 sums
    of bf16 terms of one magnitude would be exact in any order); with
    `misaligned`, C is a view one element into its storage."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    groups = -(-d // 16)
    mask = torch.zeros((e, rs._mask_lanes(d)), device=dev)
    mask[:, :groups] = torch.randint(0, 2 ** 16, (e, groups), generator=gen,
                                     device=dev).float()
    x = torch.randn(e * d + 1, generator=gen, device=dev) * torch.exp2(
        torch.randint(-8, 9, (e * d + 1,), generator=gen, device=dev))
    x = x.to(torch.bfloat16)
    c = (x[1:] if misaligned else x[:-1]).view(e, d)
    return mask, c


def k15b_check(dev, mask, c, ranks, rows, leak, name):
    """K15b against its plain version and its earlier body, then into NaN
    tables; one launch of each in the first part."""
    before = dict(rs.LAUNCHES)
    got = rs._masked_segsum_impl(mask, c, ranks, table_rows=rows, leak=leak)
    walk = ed.masked_segsum_walk(mask, c, ranks, table_rows=rows, leak=leak)
    torch.cuda.synchronize()
    assert launched(before) == {"masked_segsum": 1, "masked_segsum_walk": 1}
    assert got.dtype == torch.float32 and got.shape == (rows, c.shape[1])
    terms = masked_terms(torch, rs, mask, c, leak)
    check_kernel(name, got, rs._masked_segsum_plain(mask, c, ranks, rows,
                                                    leak),
                 row_abs_sums(torch, rows, ranks, terms),
                 row_counts(torch, rows, ranks), torch)
    masked_segsum_design_check(torch, rs, name + " = its earlier design's",
                               got, walk, mask, c, ranks, leak)
    masked_segsum_table_check(
        torch, name + " into a NaN table",
        masked_segsum_nan_tables(torch, rs, mask, c, ranks, rows, leak), ranks)
    return got


@pytest.mark.parametrize("leak", [v for _, v in LEAKS])
@pytest.mark.parametrize("d", [16, 24, 100, 128, 320])
def test_masked_segsum_rows_on_qm9_src_ranks(dev, d, leak):
    """D 16 (two lanes a chunk), 24 and 100 (a pad lane; 100 the 2-byte
    path), 128 (QM9's width), 320 (a chunk's lanes over two blocks)."""
    ranks, rows = qm9_src_ranks()
    ranks = ranks.to(dev)
    assert bool(seam_rows(torch, ranks, rows).any())
    mask, c = inputs(dev, ranks.shape[0], d, d)
    k15b_check(dev, mask, c, ranks, rows, leak,
               "masked_segsum D=%d leak %g" % (d, leak))


def run_ranks(sizes, start=0, stride=1):
    """Nondecreasing int32 ranks: run i of sizes[i] edges has rank start +
    stride * i."""
    return torch.from_numpy(np.repeat(
        start + stride * np.arange(len(sizes), dtype=np.int32), sizes))


@pytest.mark.parametrize("leak", [v for _, v in LEAKS])
@pytest.mark.parametrize("case", ["1000-edge run", "long runs", "gapped",
                                  "E 3237", "unaligned C"])
def test_masked_segsum_rows_on_made_ranks(dev, case, leak):
    """A 1,000-edge run (16 chunks) between short ones; runs of 15 to 50
    chunks (the join's batches of 16 partials end at every place of a
    run, the last run at the stream's end); ranks with a gap after every
    run, starting at 3, in a table 7 rows past the last (rows no edge
    reaches before, between and after); E 3,237 (a last chunk of 37
    edges); a C stream that is not 16-byte aligned (the 2-byte path at D
    128)."""
    rng = np.random.RandomState(11)
    d = 128
    if case == "1000-edge run":
        ranks = run_ranks(np.concatenate([rng.randint(1, 4, 300), [1000],
                                          rng.randint(1, 4, 300)]))
    elif case == "long runs":
        longs = [64 * m + 17 * m % 64 for m in range(15, 51)]
        ranks = run_ranks(np.stack([rng.randint(1, 4, len(longs)), longs],
                                   1).reshape(-1))
    elif case == "gapped":
        ranks = run_ranks(rng.randint(1, 9, 500), start=3, stride=2)
    else:
        ranks = run_ranks(rng.randint(1, 5, 2000))[:3237]
    ranks = ranks.to(dev)
    rows = int(ranks[-1]) + (7 if case == "gapped" else 1)
    mask, c = inputs(dev, ranks.shape[0], d, 5, case == "unaligned C")
    assert (c.data_ptr() % 16 != 0) == (case == "unaligned C")
    k15b_check(dev, mask, c, ranks, rows, leak,
               "masked_segsum (%s, leak %g)" % (case, leak))


@pytest.mark.parametrize("leak", [v for _, v in LEAKS])
def test_masked_segsum_rows_on_the_diluted_stream(dev, leak):
    """The diluted src stream of a graph of PPI-like degree: runs over
    three chunks, fill slots with zero C rows, rows past the last rank."""
    from chip_smoke import ppi_like_graph
    from tf_gnn_samples_torch.nn.layers import src_stream
    from tf_gnn_samples_torch.ops.graph import SD_FILL

    graph = ppi_like_graph(dev, num_nodes=2048)
    fine, ranks, _ = src_stream(graph.flat)
    rows = graph.flat.src_from_rank.shape[0]
    assert rows > int(ranks[-1]) + 1
    mask, c = inputs(dev, ranks.shape[0], 128, 9)
    c[fine == int(SD_FILL)] = 0
    k15b_check(dev, mask, c, ranks, rows, leak,
               "masked_segsum (diluted, leak %g)" % leak)


def test_masked_segsum_empty_stream_is_a_zero_table(dev):
    before = dict(rs.LAUNCHES)
    out = rs._masked_segsum_impl(
        torch.zeros((0, 8), device=dev),
        torch.zeros((0, 128), dtype=torch.bfloat16, device=dev),
        torch.zeros(0, dtype=torch.int32, device=dev), table_rows=5,
        leak=0.0)
    assert out.shape == (5, 128) and not out.any()
    assert launched(before) == {}


def test_masked_segsum_wrapper_refuses_what_the_kernel_does_not_take(dev):
    ranks, rows = qm9_src_ranks()
    ranks = ranks.to(dev)
    e = ranks.shape[0]
    mask = torch.zeros((e, 8), device=dev)
    c = torch.zeros((e, 128), dtype=torch.bfloat16, device=dev)
    before = dict(rs.LAUNCHES)
    with pytest.raises(TypeError):  # an int32 mask
        rs._masked_segsum_impl(mask.int(), c, ranks, table_rows=rows,
                               leak=0.0)
    with pytest.raises(TypeError):  # an f32 C stream
        rs._masked_segsum_impl(mask, c.float(), ranks, table_rows=rows,
                               leak=0.0)
    with pytest.raises(TypeError):  # int64 ranks
        rs._masked_segsum_impl(mask, c, ranks.long(), table_rows=rows,
                               leak=0.0)
    with pytest.raises(ValueError):  # seven lanes hold 112 of 128 columns
        rs._masked_segsum_impl(mask[:, :7], c, ranks, table_rows=rows,
                               leak=0.0)
    with pytest.raises(ValueError):  # a transposed C view
        rs._masked_segsum_impl(mask, c.t().contiguous().t(), ranks,
                               table_rows=rows, leak=0.0)
    assert rs.LAUNCHES == before  # nothing refused was launched
