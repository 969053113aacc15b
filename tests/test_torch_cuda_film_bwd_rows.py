"""K3 film_src_bwd and K4 film_bwd in their Hopper design
(csrc/film_rows.cuh) on the card: each against its plain version within
the order bound (chip_smoke.check_kernel) and against its earlier design
(tools/earlier_designs.py: csrc/film_src_bwd_walk.cu, film_bwd_walk.cu)
bit for bit on every row of at most two 64-edge chunks
(chip_smoke.film_design_check), for every activation on a QM9 batch's real
ranks, and on a diluted src stream (K3), gapped ranks (K4), a rank run over
1,000 edges and an E that is no multiple of 64, for D in 16, 100, 128 and
320 (16-byte and 2-byte accesses). K3's gather form equals its stream
form and leaves the rows no real edge feeds zero; K4's split form equals
its gamma|beta|g form and its d_gb equals K2's; the wrappers refuse what
the kernels do not take.

Marked `cuda`; every test skips without a GPU. This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_film_bwd_rows.py
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_cuda_film_rows as film_rows
from chip_smoke import (check_exact, check_kernel, film_bwd_design_check,
                        film_design_check, film_terms, ppi_like_graph,
                        row_abs_sums, row_counts, src_gather_check,
                        src_terms)
from tf_gnn_samples_torch.nn.layers import src_stream
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.ops.graph import SD_FILL
from tf_gnn_samples_torch.tools import earlier_designs as ed

pytestmark = pytest.mark.cuda

WIDTHS = film_rows.WIDTHS


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def src_side(kind):
    """K3's stream: int32 src ranks [E], fine keys [E], each src group's t
    row [rows] and the heights (rows, RPAD, t rows). "qm9": the src stream
    of a 10,000-node pack of QM9's validation fold; "diluted": the diluted
    stream of a PPI-like graph (SD_FILL fill slots); "long_run" and
    "ragged": the ranks of test_torch_cuda_film_rows.stream, with random
    fine keys (one in eight SD_FILL) and t rows (some outside the table,
    so clipped)."""
    if kind in ("qm9", "diluted"):
        if kind == "qm9":
            from tf_gnn_samples_torch.tasks import base, qm9
            task = qm9.QM9_Task(qm9.QM9_Task.default_params())
            data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:700]
            graph = next(task.make_minibatch_iterator(
                data, base.DataFold.VALIDATION, 10000)).graph
        else:
            graph = ppi_like_graph(torch.device("cpu"), num_nodes=2048)
        flat = graph.flat
        fine, ranks, _ = src_stream(flat)
        assert bool(flat.win_sd) == (kind == "diluted")
        return (ranks.numpy(), fine.numpy(), flat.src_from_rank.numpy(),
                flat.src_from_rank.shape[0], flat.fine_to_flat.shape[0],
                graph.num_edge_types * graph.n_pad)
    ranks, rows = film_rows.stream(kind)
    rng = np.random.RandomState(1)
    rpad, t_rows = 1500, 1200
    fine = rng.randint(0, rpad, size=len(ranks)).astype(np.int32)
    fine[rng.rand(len(ranks)) < 0.125] = SD_FILL
    t_index = rng.randint(-2, t_rows + 5, size=rows).astype(np.int32)
    return np.asarray(ranks, np.int32), fine, t_index, rows, rpad, t_rows


def src_inputs(dev, kind, d):
    ranks, fine, t_index, rows, rpad, t_rows = src_side(kind)
    gen = torch.Generator(device=dev).manual_seed(d)

    def randn(*shape):
        return (2 * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)

    as_dev = functools.partial(torch.as_tensor, device=dev)
    return (randn(rpad, 2 * d), randn(rpad, d), as_dev(fine),
            randn(t_rows, d), as_dev(t_index), as_dev(ranks), rows)


def check_src(kind, act, d, dev):
    gb, g, fine, t, t_index, ranks, rows = src_inputs(dev, kind, d)
    before = rs.LAUNCHES["film_src_bwd"]
    got = rs._film_src_bwd_gather_impl(gb, g, fine, t, t_index, ranks,
                                       table_rows=rows, act=act)
    gcb, t_ranked = rs._src_stream_inputs(gb, g, fine, t, t_index)
    stream = rs._film_src_bwd_impl(gcb, t_ranked, ranks, table_rows=rows,
                                   act=act)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["film_src_bwd"] == before + 2
    name = "film_src_bwd %s D=%d %s" % (kind, d, act)
    plain = rs._film_src_bwd_gather_plain(gb, g, fine, t, t_index, ranks,
                                          rows, act)
    terms = src_terms(torch, rs, gcb, t_ranked, ranks, act)
    abs_sums = row_abs_sums(torch, rows, ranks, terms)
    counts = row_counts(torch, rows, ranks)
    check_kernel(name, got, plain, abs_sums, counts, torch)
    check_kernel(name + " (stream form)", stream, plain, abs_sums, counts,
                 torch)
    film_design_check(torch, name, got, ed.film_src_bwd_walk(
        gcb, t_ranked, ranks, table_rows=rows, act=act), ranks)
    fed = torch.zeros(rows, dtype=torch.bool, device=dev)
    fed[ranks[(fine >= 0) & (fine < g.shape[0])].long()] = True
    assert int((~fed).sum()) > 0
    src_gather_check(torch, name + " gather = stream", got, stream, ranks,
                     fed)


def check_bwd(kind, act, d, dev):
    msgs, gbg, ranks = film_rows.inputs(dev, kind, d, 3)
    rows = gbg.shape[0]
    gb, g = gbg[:, :2 * d].contiguous(), gbg[:, 2 * d:].contiguous()
    before = rs.LAUNCHES["film_bwd"]
    got = rs._film_bwd_split_impl(msgs, gb, g, ranks, act=act)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["film_bwd"] == before + 1
    name = "film_bwd %s D=%d %s" % (kind, d, act)
    dm_want, dgb_want = rs._film_bwd_plain(msgs, gbg, ranks, act)
    check_exact(name + " d_msgs", got[0], dm_want, torch)
    terms = film_terms(torch, rs, msgs, gbg, ranks, act)
    check_kernel(name, got[1], dgb_want,
                 row_abs_sums(torch, rows, ranks, terms),
                 row_counts(torch, rows, ranks), torch)
    film_bwd_design_check(torch, name, got,
                          ed.film_bwd_walk(msgs, gbg, ranks, act=act), ranks)
    film_bwd_design_check(torch, name + " gamma|beta|g form",
                          rs._film_bwd_impl(msgs, gbg, ranks, act=act), got,
                          ranks)
    film_design_check(torch, name + " d_gb = K2's", got[1],
                      rs._film_bwd_dgb_split_impl(msgs, gb, g, ranks,
                                                  act=act), ranks)
    empty = torch.ones(rows, dtype=torch.bool, device=dev)
    empty[ranks.long()] = False
    assert int(empty.sum()) > 0 and not got[1][empty].any()


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("act", sorted(rs.ACT_IDS))
@pytest.mark.parametrize("half", ["src", "bwd"])
def test_film_bwd_rows_on_qm9_ranks(dev, half, act, d):
    (check_src if half == "src" else check_bwd)("qm9", act, d, dev)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", ["diluted", "long_run", "ragged"])
def test_film_src_bwd_rows_on_other_streams(dev, kind, d):
    check_src(kind, "elu", d, dev)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", ["gapped", "long_run", "ragged"])
def test_film_bwd_rows_on_other_streams(dev, kind, d):
    check_bwd(kind, "elu", d, dev)


def test_k3_k4_wrappers_refuse_what_the_kernels_do_not_take(dev):
    gb, g, fine, t, t_index, ranks, rows = src_inputs(dev, "ragged", 64)
    gather = functools.partial(rs._film_src_bwd_gather_impl, table_rows=rows,
                               act="elu")
    before = dict(rs.LAUNCHES)
    with pytest.raises(TypeError):
        gather(gb.float(), g, fine, t, t_index, ranks)
    with pytest.raises(TypeError):
        gather(gb, g, fine.long(), t, t_index, ranks)
    with pytest.raises(TypeError):
        gather(gb, g, fine, t, t_index.long(), ranks)
    with pytest.raises(TypeError):
        gather(gb, g, fine, t, t_index, ranks.long())
    with pytest.raises(ValueError):  # g's columns not contiguous
        gather(gb, g.t().contiguous().t(), fine, t, t_index, ranks)
    with pytest.raises(ValueError):  # t not contiguous
        gather(gb, g, fine, t.t().contiguous().t(), t_index, ranks)
    with pytest.raises(ValueError):
        gather(gb, g, fine, t.cpu(), t_index, ranks)
    with pytest.raises(TypeError):  # the stream form's f32 stream
        rs._film_src_bwd_impl(
            torch.zeros((len(ranks), 192), device=dev),
            torch.zeros((rows, 64), dtype=torch.bfloat16, device=dev), ranks,
            table_rows=rows, act="elu")
    msgs, gbg, k4_ranks = film_rows.inputs(dev, "ragged", 64, 3)
    split = functools.partial(rs._film_bwd_split_impl, act="elu")
    gb4, g4 = gbg[:, :128].contiguous(), gbg[:, 128:].contiguous()
    with pytest.raises(TypeError):
        split(msgs.float(), gb4, g4, k4_ranks)
    with pytest.raises(TypeError):
        split(msgs, gb4, g4, k4_ranks.long())
    with pytest.raises(ValueError):
        split(msgs, gb4, g4.t().contiguous().t(), k4_ranks)
    with pytest.raises(ValueError):
        split(msgs, gb4, g4.cpu(), k4_ranks)
    with pytest.raises(ValueError):
        split(msgs.t().contiguous().t(), gb4, g4, k4_ranks)
    assert rs.LAUNCHES == before  # nothing refused was launched
