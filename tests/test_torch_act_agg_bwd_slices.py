"""K12b over several stream slices in one call (`_act_agg_bwd_slices_impl`,
what GNN-Edge-MLP1's backward calls once for all its streamed edge types)
against the JAX package's `_act_agg_bwd_impl` called slice by slice, in
interpret mode, on the CPU (where the port's wrapper runs the plain
version): 1, 4, 22 and 40 slices of 100-300 edges (40 take two launches
on the card), one of them empty; relu, elu and gelu; D 128 and D 20 (not
a multiple of 8: the kernel's single-column form). Also the wrapper's
argument checks, its earlier design on the CPU, and the shared launch
path (`_run`) through a stub entry point: a nonzero return raises and
counts nothing, a good launch counts once."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.tools import earlier_designs
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs

from test_torch_edge_mlp import bf16_pair

STEP = 2048  # the JAX kernels' edge block: each slice is padded to one
ROWS = 8192  # one cotangent table height for every case (one JAX compile
             # a width and activation)
# Slices of each case, and the widths it runs at; the 22-slice case and
# the two-group one only at the narrow width.
CASES = [(1, 128), (4, 128), (4, 20), (22, 20), (40, 20)]


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)


def bf16_pair_np(x):
    """The same bf16 values for both packages, rounded (to nearest) in
    numpy: no JAX operation compiles per slice shape."""
    j = x.astype(jnp.bfloat16)
    t = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(j.astype(np.float32), t.to(torch.float32).numpy())
    return j, t


def slices_of(rng, count, d):
    """`count` slices of 100-300 edges (the second one empty where there
    are more than one) whose gap-free rank runs of 1-6 edges take disjoint
    rows of one table, slice after slice, and their bf16 messages for both
    packages."""
    out, base = [], 0
    for i in range(count):
        e = 0 if i == 1 else int(rng.randint(100, 301))
        run = np.repeat(np.arange(e), rng.randint(1, 7, size=e))[:e]
        ranks = (base + run).astype(np.int32)
        base += int(run[-1]) + 1 if e else 0
        msgs = (1.5 * rng.randn(e, d)).astype(np.float32)
        out.append((bf16_pair_np(msgs), ranks))
    assert base <= ROWS - 264  # the JAX kernels' window past the last rank
    return out


def jax_per_slice(jm, ranks, jg16, act):
    """The JAX package's K12b on one slice, padded to a whole edge block
    with its last edge repeated (each edge's value is its own: the pad
    rows are dropped)."""
    e = ranks.shape[0]
    if e == 0:
        return np.zeros((0, jg16.shape[1]), np.float32)
    pad = STEP - e
    jm = jnp.asarray(np.concatenate([jm, np.repeat(jm[-1:], pad, axis=0)]))
    jr = jnp.asarray(np.concatenate([ranks, np.repeat(ranks[-1:], pad)]))
    out = j_rs._act_agg_bwd_impl(jm, jg16, jr, block_edges=256, act=act,
                                 win=0)
    return np.asarray(out).astype(np.float32)[:e]


@pytest.mark.parametrize("act", ["relu", "elu", "gelu"])
@pytest.mark.parametrize("count,d", CASES)
def test_act_agg_bwd_slices_match_pallas_per_slice(count, d, act):
    """One call over all the slices against one JAX call per slice: bit
    for bit for relu and elu; gelu equal or a neighbouring bf16 number (the
    two libraries' erf may differ in the last f32 bit before the one
    rounding, as tests/test_torch_edge_mlp.py holds K12b of one slice).
    The one-slice entry and the earlier design (one launch a slice) give
    the same bits on each slice."""
    rng = np.random.RandomState(19 + count + d)
    slices = slices_of(rng, count, d)
    jg16, tg16 = bf16_pair(rng.randn(ROWS, d).astype(np.float32))
    pieces = [(tm, torch.from_numpy(r)) for (_, tm), r in slices]
    got = t_rs._act_agg_bwd_slices_impl(pieces, tg16, act)
    assert len(got) == count
    for ((jm, tm), r), d_l in zip(slices, got):
        assert d_l.dtype == torch.bfloat16 and d_l.shape == tm.shape
        want = jax_per_slice(jm, r, jg16, act)
        if act == "gelu":
            np.testing.assert_allclose(d_l.float().numpy(), want,
                                       rtol=2.0 ** -7, atol=1e-6)
        else:
            assert np.array_equal(d_l.float().numpy(), want)
        assert torch.equal(d_l, t_rs._act_agg_bwd_impl(
            tm, tg16, torch.from_numpy(r), act=act))
    for d_l, earlier in zip(got, earlier_designs.act_agg_bwd_per_slice(
            pieces, tg16, act=act)):
        assert torch.equal(d_l, earlier)
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


def test_act_agg_bwd_slices_check_their_arguments():
    bf = torch.bfloat16
    m, ranks = torch.zeros(8, 4, dtype=bf), torch.zeros(8, dtype=torch.int32)
    g16 = torch.zeros(5, 4, dtype=bf)
    bwd = t_rs._act_agg_bwd_slices_impl
    out = bwd([(m, ranks), (m[:0], ranks[:0])], g16, "elu")
    assert [tuple(o.shape) for o in out] == [(8, 4), (0, 4)]
    with pytest.raises(ValueError):  # no slices
        bwd([], g16, "elu")
    with pytest.raises(ValueError):  # two widths
        bwd([(m, ranks), (torch.zeros(8, 3, dtype=bf), ranks)], g16, "elu")
    with pytest.raises(ValueError):  # ranks not one per edge
        bwd([(m, ranks), (m, ranks[:7])], g16, "elu")
    with pytest.raises(ValueError):  # a table of another width
        bwd([(m, ranks)], torch.zeros(5, 3, dtype=bf), "elu")
    with pytest.raises(ValueError):  # a 1-D table
        bwd([(m, ranks)], torch.zeros(5, dtype=bf), "elu")
    with pytest.raises(ValueError):  # no slices, earlier design
        earlier_designs.act_agg_bwd_per_slice([], g16, act="elu")


@pytest.fixture
def stub_launch(monkeypatch):
    """_run with a stub entry point for "expand_t" on cuda:0 (the current
    device), launch counters of its own; yields the stub's record of
    calls and a setter for its return code."""
    calls, rc = [], [0]

    def stub(*args):
        calls.append(args)
        return rc[0]

    monkeypatch.setattr(t_rs, "_ENTRIES", {"expand_t": stub})
    monkeypatch.setattr(t_rs, "_current_device", lambda: 0)
    monkeypatch.setattr(t_rs, "_raw_stream", lambda index: 0xABC)
    monkeypatch.setattr(t_rs, "LAUNCHES", dict.fromkeys(t_rs.LAUNCHES, 0))
    yield calls, lambda code: rc.__setitem__(0, code)


def test_run_raises_on_a_failed_launch_and_counts_nothing(stub_launch):
    calls, set_rc = stub_launch
    set_rc(700)  # cudaErrorIllegalAddress
    before = dict(t_rs.LAUNCHES)
    with pytest.raises(RuntimeError, match="expand_t.*CUDA error 700"):
        t_rs._run("expand_t", 0, (1, 2, 3))
    assert calls == [(1, 2, 3, 0xABC)]
    assert t_rs.LAUNCHES == before


def test_run_counts_a_good_launch_once(stub_launch):
    calls, _ = stub_launch
    before = dict(t_rs.LAUNCHES)
    t_rs._run("expand_t", 0, (4, 5))
    t_rs._run("expand_t", 0, (6,), counter="expand")
    assert calls == [(4, 5, 0xABC), (6, 0xABC)]
    assert {k: n - before[k] for k, n in t_rs.LAUNCHES.items() if n} == {
        "expand_t": 1, "expand": 1}


def test_laid_out_ptrs_check_device_and_layout():
    """The layout check that _call runs before a launch: a tensor on
    another device, or not contiguous (not a row view where one is
    allowed), is refused; None passes as a null pointer."""
    x = torch.zeros(4, 6)
    ptrs = t_rs._laid_out_ptrs("k", (x, None, x[:, :3]), -1, row_views=(2,))
    assert ptrs == [x.data_ptr(), None, x.data_ptr()]
    with pytest.raises(ValueError, match="k: inputs"):
        t_rs._laid_out_ptrs("k", (x, x[:, :3]), -1)  # not contiguous
    with pytest.raises(ValueError, match="k: inputs"):
        t_rs._laid_out_ptrs("k", (x, x.t()), -1, row_views=(1,))
    with pytest.raises(ValueError, match="k: inputs"):
        t_rs._laid_out_ptrs("k", (x,), 0)  # a CPU tensor for cuda:0
