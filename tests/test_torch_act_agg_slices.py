"""K12a over several stream slices in one call (`_act_agg_slices_impl`,
what GNN-Edge-MLP1's layer calls once for all its streamed edge types),
against the JAX package's `_act_agg_impl` summed slice by slice, in
interpret mode, on the CPU (where the port's wrapper runs the plain
version): the four streamed type slices of a QM9 pack, the same with an
empty slice among them, and 23 slices of disjoint rank rows as a
VarMisuse batch's edge types give. Also the wrapper's argument checks and
the port CLI's help, which names all seven model families."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs

from test_torch_edge_mlp import EXACT_ACTS, SUMS, bf16_pair

STEP = 2048  # the JAX kernels' edge block: a slice is a whole number of them


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


@pytest.fixture(scope="module")
def qm9_tm():
    """The type-major ranks and offsets of the first 600-node QM9 pack: a
    self-loop slice, then four streamed slices of 2,048 edges."""
    task = t_qm9.QM9_Task(t_qm9.QM9_Task.default_params())
    data = task._QM9_Task__load_data("data/qm9/valid.jsonl.gz")[:200]
    flat = next(task.make_minibatch_iterator(
        data, t_base.DataFold.VALIDATION, 600)).graph.flat
    assert flat.tm_self == (True, False, False, False, False)
    return flat.tm_rank, flat.tm_offs, flat.tm_to_flat.shape[0]


def many_slices(rng, count=23):
    """`count` slices of STEP edges each, whose gap-free rank runs of 1-6
    edges take disjoint rows, one slice after the other, and a table with
    the slack rows that the JAX kernels' windows need past the last rank
    (rank_table_rows' block_edges + 8)."""
    ranks, offs, base = [], [0], 0
    for _ in range(count):
        sizes = rng.randint(1, 7, size=STEP)
        run = np.repeat(np.arange(STEP), sizes)[:STEP]
        ranks.append(base + run)
        base += int(run[-1]) + 1
        offs.append(offs[-1] + STEP)
    return (torch.from_numpy(np.concatenate(ranks).astype(np.int32)),
            tuple(offs), -(-base // 8) * 8 + 256 + 8)


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("which,d", [("qm9", 32), ("qm9_empty", 32),
                                     ("varmisuse", 16)])
def test_act_agg_slices_match_pallas_summed_per_slice(qm9_tm, which, d, act):
    """One call over all the slices against one JAX call per slice, the
    tables summed. relu within the f32 sum order (SUMS); gelu as
    tests/test_torch_edge_mlp.py holds K12a's single slice: a term whose
    activation differs in its last f32 bit between the two libraries may
    round to the neighbouring bf16 number."""
    rng = np.random.RandomState(11)
    if which == "varmisuse":
        ranks, offs, rows = many_slices(rng)
        bounds = list(zip(offs[:-1], offs[1:]))
    else:
        ranks, offs, rows = qm9_tm
        bounds = list(zip(offs[1:-1], offs[2:]))  # the streamed types
        if which == "qm9_empty":
            bounds.insert(2, (offs[3], offs[3]))
    msgs = (1.5 * rng.randn(ranks.shape[0], d)).astype(np.float32)
    jm, tm = bf16_pair(msgs)
    jranks = jnp.asarray(ranks.numpy())
    want = np.zeros((rows, d), np.float32)
    for lo, hi in bounds:
        if hi > lo:
            want += np.asarray(j_rs._act_agg_impl(
                jm[lo:hi], jranks[lo:hi], table_rows=rows, block_edges=256,
                act=act, win=0))
    slices = [(tm[lo:hi], ranks[lo:hi]) for lo, hi in bounds]
    got = t_rs._act_agg_slices_impl(slices, table_rows=rows, act=act)
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    if act in EXACT_ACTS:
        np.testing.assert_allclose(got.numpy(), want, **SUMS)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=8 * 2.0 ** -8)
    # The one-slice entry on each slice adds up to the same table.
    each = sum(t_rs._act_agg_impl(m, r, table_rows=rows, act=act)
               for m, r in slices)
    assert torch.equal(got, each)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


def test_act_agg_slices_check_their_arguments():
    bf = torch.bfloat16
    m, ranks = torch.zeros(8, 4, dtype=bf), torch.zeros(8, dtype=torch.int32)
    agg = t_rs._act_agg_slices_impl
    out = agg([(m, ranks), (m[:0], ranks[:0])], table_rows=5, act="elu")
    assert out.shape == (5, 4) and out.dtype == torch.float32
    table = torch.zeros(5, 4)
    assert agg([(m, ranks)], table_rows=5, act="elu", out=table) is table
    with pytest.raises(ValueError):  # no slices
        agg([], table_rows=5, act="elu")
    with pytest.raises(ValueError):  # two widths
        agg([(m, ranks), (torch.zeros(8, 3, dtype=bf), ranks)],
            table_rows=5, act="elu")
    with pytest.raises(ValueError):  # ranks not one per edge
        agg([(m, ranks), (m, ranks[:7])], table_rows=5, act="elu")
    with pytest.raises(ValueError):  # a 1-D stream
        agg([(m[:, 0], ranks)], table_rows=5, act="elu")
    with pytest.raises(ValueError):  # a table of another height
        agg([(m, ranks)], table_rows=5, act="elu", out=torch.zeros(6, 4))
    assert t_rs.ACT_AGG_MAX_SLICES >= 32


def test_train_cli_help_names_all_seven_families():
    """The port's train CLI names every registered family, as the
    reference CLI's help does (RGIN and RGDCN were missing)."""
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "--help"],
        check=True, capture_output=True, text=True).stdout
    text = " ".join(out.split())
    for family in ("GGNN", "RGCN", "RGAT", "RGIN", "GNN-Edge-MLP0",
                   "GNN-Edge-MLP1", "RGDCN", "GNN-FiLM"):
        assert family in text, family
    assert "seven" in text
