"""K12a act_agg (one launch over several stream slices, csrc/act_agg.cu)
and K9 rgat_src_bwd (each chunk's rows staged in shared memory, and its
gather form that reads the side table through fine keys,
csrc/rgat_src_bwd.cu) on the card: each
against its plain version within the order bound (chip_smoke.check_kernel;
K9 with one bf16 step a term and the cancellation slack of
chip_smoke.rgat_src_bwd_bounds) and against its earlier body
(tools/earlier_designs.py: csrc/act_agg_walk.cu, one launch a slice, and
csrc/rgat_src_bwd_walk.cu) bit for bit on every row of at most two
64-edge chunks of its slice (chip_smoke.slices_design_check,
film_design_check). K12a on the type-major slices of a QM9 pack (every
activation; D 16, 100, 128 and 320; a stream whose rows are not 4-byte
aligned), with empty slices and with 40 slices (two launches); K9's two
forms on a QM9 batch's src stream and on a diluted one, for D and heads
that take 16-, 4- and 2-byte accesses (D 320 with 4 heads: PPI's rows)
and 96 heads (opted-in shared memory; more than the earlier body takes),
equal to each other; the wrappers refuse what the kernels do not take.

Marked `cuda`; every test skips without a GPU. This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_act_agg_rgat_rows.py
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_cuda_film_bwd_rows as film_bwd_rows
from chip_smoke import (check_kernel, film_design_check, rgat_src_bwd_bounds,
                        row_abs_sums, row_counts, slices_design_check,
                        src_gather_check)
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.tools import earlier_designs as ed

pytestmark = pytest.mark.cuda

WIDTHS = [16, 100, 128, 320]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def type_major():
    """The type-major ranks, slice offsets, self-loop flags and table
    height of a 10,000-node pack of QM9's validation fold."""
    from tf_gnn_samples_torch.tasks import base, qm9
    task = qm9.QM9_Task(qm9.QM9_Task.default_params())
    data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:700]
    flat = next(task.make_minibatch_iterator(
        data, base.DataFold.VALIDATION, 10000)).graph.flat
    return (flat.tm_rank.numpy(), flat.tm_offs, flat.tm_self,
            flat.tm_to_flat.shape[0])


def k12a_check(dev, msgs, slices, rows, act, name, launches=1):
    """One _act_agg_slices_impl call over `slices` ([(lo, hi)] of msgs and
    the type-major ranks) against its plain version and against the
    earlier body, one launch a slice."""
    ranks = torch.as_tensor(type_major()[0], device=dev)
    pieces = [(msgs[lo:hi], ranks[lo:hi]) for lo, hi in slices]
    before = dict(rs.LAUNCHES)
    got = rs._act_agg_slices_impl(pieces, table_rows=rows, act=act)
    torch.cuda.synchronize()
    assert {k: rs.LAUNCHES[k] - before[k] for k in before} == dict(
        {k: 0 for k in before}, act_agg=launches)
    assert got.dtype == torch.float32 and got.shape == (rows, msgs.shape[1])
    idx = torch.cat([torch.arange(lo, hi, device=dev) for lo, hi in slices])
    terms = rs._bf16_terms(rs._ACTS[act][0](msgs.index_select(0, idx).float()))
    every = ranks.index_select(0, idx)
    check_kernel(name, got, rs._act_agg_slices_plain(pieces, rows, act),
                 row_abs_sums(torch, rows, every, terms),
                 row_counts(torch, rows, every), torch)
    walk = torch.zeros_like(got)
    for m, r in pieces:
        ed.act_agg_walk(m, r, table_rows=rows, act=act, out=walk)
    slices_design_check(torch, name + " = its earlier design's", got, walk,
                        [r for _, r in pieces])
    fed = torch.zeros(rows, dtype=torch.bool, device=dev)
    fed[every.long()] = True
    assert bool((~fed).any()) and not got[~fed].any()
    return got


def tm_msgs(dev, d, seed, misaligned=False):
    ranks, _, _, _ = type_major()
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (2 * torch.randn(len(ranks) * d + 1, generator=gen, device=dev)).to(
        torch.bfloat16)
    # A view one element into its storage: rows not 4-byte aligned.
    return (x[1:] if misaligned else x[:-1]).view(len(ranks), d)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("act", sorted(rs.ACT_IDS))
def test_act_agg_layer_on_qm9_slices(dev, act, d):
    """One launch over the four streamed types' slices, as a GNN-Edge-MLP1
    layer calls it, and one over each slice alone."""
    _, offs, tm_self, rows = type_major()
    parts = [(offs[l], offs[l + 1]) for l in range(len(tm_self))
             if not tm_self[l]]
    assert len(parts) == 4
    msgs = tm_msgs(dev, d, d)
    layer = k12a_check(dev, msgs, parts, rows, act,
                       "act_agg layer D=%d %s" % (d, act))
    each = sum(k12a_check(dev, msgs, [p], rows, act,
                          "act_agg [%d:%d] D=%d %s" % (p + (d, act)))
               for p in parts)
    ranks = torch.as_tensor(type_major()[0], device=dev)
    slices_design_check(torch, "act_agg layer = its slices' sum", layer,
                        each, [ranks[lo:hi] for lo, hi in parts])


def test_act_agg_unaligned_empty_and_many_slices(dev):
    """A stream whose rows are not 4-byte aligned (2-byte loads); empty
    slices among live ones, and only empty ones (no launch); 40 slices,
    cut from the whole stream, in two launches."""
    ranks, offs, _, rows = type_major()
    msgs = tm_msgs(dev, 128, 5, misaligned=True)
    assert msgs.data_ptr() % 4
    parts = [(offs[1], offs[2]), (offs[2], offs[2]), (offs[3], offs[5])]
    k12a_check(dev, msgs, parts, rows, "gelu", "act_agg unaligned")
    before = rs.LAUNCHES["act_agg"]
    t = torch.as_tensor(ranks, device=dev)
    out = rs._act_agg_slices_impl([(msgs[:0], t[:0])] * 3, table_rows=rows,
                                  act="gelu")
    assert rs.LAUNCHES["act_agg"] == before and not out.any()
    # Cut points where the rank changes: the slices' rank rows disjoint.
    change = np.flatnonzero(np.diff(ranks)) + 1
    cuts = [0] + [int(change[i]) for i in np.linspace(
        0, len(change) - 1, 39).astype(int)] + [len(ranks)]
    many = [(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
    assert len(many) > rs.ACT_AGG_MAX_SLICES
    k12a_check(dev, tm_msgs(dev, 64, 6), many, rows, "elu",
               "act_agg %d slices" % len(many),
               launches=-(-len(many) // rs.ACT_AGG_MAX_SLICES))


def k9_inputs(dev, kind, k, d):
    """K9's side table, the fine keys, the stream the stream form reads,
    the t | lsrc table and the src ranks of film_bwd_rows.src_side's
    stream `kind`; a few logits beyond the clamp."""
    ranks, fine, _, rows, rpad, _ = film_bwd_rows.src_side(kind)
    gen = torch.Generator(device=dev).manual_seed(d + k)
    side = torch.randn((rpad, d + 3 * k), generator=gen, device=dev)
    side[:, d + k:d + 2 * k] = 0.5 + 4 * torch.rand((rpad, k), generator=gen,
                                                    device=dev)
    side[::37, d:d + k] = 80.0
    side = side.to(torch.bfloat16)
    fine = torch.as_tensor(fine, device=dev)
    t_ext = torch.randn((rows, d + k), generator=gen, device=dev).to(
        torch.bfloat16)
    return (side, fine, rs._side_rows(side, fine), t_ext,
            torch.as_tensor(ranks, device=dev), rows)


@pytest.mark.parametrize("k,d", [(8, 128), (8, 64), (4, 320), (4, 200),
                                 (8, 48), (3, 48), (1, 64), (16, 128),
                                 (96, 192)])
@pytest.mark.parametrize("kind", ["qm9", "diluted"])
def test_rgat_src_bwd_forms_on_card(dev, kind, k, d):
    side, fine, gcb, t_ext, ranks, rows = k9_inputs(dev, kind, k, d)
    before = rs.LAUNCHES["rgat_src_bwd"]
    forms = dict(rs.FORM_LAUNCHES)
    got = rs._rgat_src_bwd_gather_impl(side, fine, t_ext, ranks,
                                       table_rows=rows, num_heads=k,
                                       clamp=50.0)
    stream = rs._rgat_src_bwd_impl(gcb, t_ext, ranks, table_rows=rows,
                                   num_heads=k, clamp=50.0)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["rgat_src_bwd"] == before + 2
    assert {f: rs.FORM_LAUNCHES[f] - forms[f] for f in forms} == {
        "rgat_src_bwd gather": 1, "rgat_src_bwd stream": 1}
    assert got.dtype == torch.float32 and got.shape == (rows, d + k)
    name = "rgat_src_bwd %s D=%d K=%d" % (kind, d, k)
    want = rs._rgat_src_bwd_plain(gcb, t_ext, ranks, rows, k, 50.0)
    abs_sums, counts, slack = rgat_src_bwd_bounds(torch, rs, gcb, t_ext,
                                                  ranks, rows, k)
    for form, out in (("gather", got), ("stream", stream)):
        check_kernel("%s (%s form)" % (name, form), out, want, abs_sums,
                     counts, torch, term_ulps=1, slack=slack)
    fed = torch.zeros(rows, device=dev).index_add_(
        0, ranks, (gcb.float().abs().sum(1) > 0).float()) > 0
    src_gather_check(torch, name + " gather = stream", got, stream, ranks,
                     fed)
    if k > ed.RGAT_SRC_WALK_MAX_HEADS:  # more than the earlier body takes
        with pytest.raises(ValueError):
            ed.rgat_src_bwd_walk(gcb, t_ext, ranks, table_rows=rows,
                                 num_heads=k, clamp=50.0)
        return
    film_design_check(torch, name + " = its earlier design's", stream,
                      ed.rgat_src_bwd_walk(gcb, t_ext, ranks, table_rows=rows,
                                           num_heads=k, clamp=50.0), ranks)


def test_k9_k12a_wrappers_refuse_what_the_kernels_do_not_take(dev):
    side, fine, gcb, t_ext, ranks, rows = k9_inputs(dev, "qm9", 8, 64)
    gather = functools.partial(rs._rgat_src_bwd_gather_impl, table_rows=rows,
                               num_heads=8, clamp=50.0)
    before, forms = dict(rs.LAUNCHES), dict(rs.FORM_LAUNCHES)
    with pytest.raises(TypeError):  # an f32 side table
        gather(side.float(), fine, t_ext, ranks)
    with pytest.raises(TypeError):
        gather(side, fine.long(), t_ext, ranks)
    with pytest.raises(TypeError):
        gather(side, fine, t_ext, ranks.long())
    with pytest.raises(ValueError):  # a side table that is a column slice
        gather(torch.cat([side, side], 1)[:, :side.shape[1]], fine, t_ext,
               ranks)
    with pytest.raises(ValueError):
        gather(side, fine.cpu(), t_ext, ranks)
    with pytest.raises(ValueError):  # more heads than shared memory takes
        rs._rgat_src_bwd_gather_impl(
            torch.zeros((8, 4 * 128), device=dev, dtype=torch.bfloat16),
            fine[:8], torch.zeros((4, 2 * 128), device=dev,
                                  dtype=torch.bfloat16), ranks[:8] * 0,
            table_rows=4, num_heads=128, clamp=50.0)
    tm, offs, _, rows12 = type_major()
    t = torch.as_tensor(tm, device=dev)
    m = torch.zeros((len(tm), 16), device=dev, dtype=torch.bfloat16)
    agg = functools.partial(rs._act_agg_slices_impl, table_rows=rows12,
                            act="gelu")
    with pytest.raises(TypeError):  # an f32 stream among bf16 ones
        agg([(m, t), (m.float(), t)])
    with pytest.raises(TypeError):
        agg([(m, t.long())])
    with pytest.raises(ValueError):  # ranks on the CPU
        agg([(m, t.cpu())])
    with pytest.raises(ValueError):  # a stream that is a column slice
        agg([(torch.zeros((len(tm), 32), device=dev,
                          dtype=torch.bfloat16)[:, :16], t)])
    with pytest.raises(TypeError):  # a bf16 table to write into
        agg([(m, t)], out=torch.zeros((rows12, 16), device=dev,
                                      dtype=torch.bfloat16))
    assert rs.LAUNCHES == before and rs.FORM_LAUNCHES == forms
