"""The K16 kernels of the port's harnesses (tf_gnn_samples_torch/tools/,
csrc/film_fwd_ab.cu, csrc/film_dgb_ab.cu, csrc/rowgather.cu) on the card:
each FiLM variant against its plain version within the order bound and
against K1 / K2 bit for bit on every row one 64-edge chunk holds; each
row gather against its plain version exactly, for a bf16 and an f32
table; at D = 320 (the tools' width) and D = 128 (the tuned QM9 width);
and the wrappers' refusals and launch counts.

Marked `cuda`; every test skips without a GPU. This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tools.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import check_exact, film_variant_check
from tf_gnn_samples_torch.ops import ranked_segment as rs
from tf_gnn_samples_torch.tools import film_fwd_ab as ffa
from tf_gnn_samples_torch.tools import rowgather_prof as rgp

pytestmark = pytest.mark.cuda

E = 16384


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def film_inputs(dev, d, gaps=None):
    """The harness's stream and tables; `gaps` spreads the ranks apart:
    "every" doubles each rank, "wide" multiplies it by 37 (a 128-edge
    block's rows then span past v2a's 128-row window), "some" leaves a
    200-row gap after every 64th rank (gapped and gap-free blocks)."""
    ranks = ffa.make_stream(E, E // 16)
    ranks = {None: ranks, "every": 2 * ranks, "wide": 37 * ranks,
             "some": ranks + ranks // 64 * 200}[gaps]
    rows = rs.rank_table_rows(int(ranks[-1]) + 2, 256)
    m, gb, gbg = (torch.from_numpy(x).to(dev, torch.bfloat16)
                  for x in ffa.make_inputs(E, d, rows))
    return m, gb, gbg, torch.from_numpy(ranks).to(dev)


FWD = [name for name, _, _ in ffa.fwd_variants()]
DGB = [name for name, _, _ in ffa.dgb_variants()] + ["v4 g=8"]


def _variant(half, name, act):
    """The harness's variant `name`, or a group the harness does not time
    (the wrappers take any group in 1, 2, 4, 8)."""
    found = {n: (c, fn) for n, c, fn in (
        ffa.fwd_variants(act) if half == "fwd" else ffa.dgb_variants(act))}
    if name in found:
        return found[name]
    kind, group = name.split(" g=")
    fn = ffa._impl_v3 if half == "fwd" else getattr(ffa, "_impl_dgb_" + kind)
    return ("film_%s_%s" % (half, kind),
            lambda m, t, r: fn(m, t, r, act=act, group=int(group)))


@pytest.mark.parametrize("d", [320, 128])
@pytest.mark.parametrize("act", ["relu", "elu"])
@pytest.mark.parametrize("half,name", [("fwd", n) for n in FWD]
                         + [("dgb", n) for n in DGB])
def test_film_variant_matches_plain_and_shipped(dev, half, name, act, d):
    m, gb, gbg, ranks = film_inputs(dev, d)
    table = gb if half == "fwd" else gbg
    counter, fn = _variant(half, name, act)
    before = rs.LAUNCHES[counter]
    got = fn(m, table, ranks)
    torch.cuda.synchronize()
    assert rs.LAUNCHES[counter] == before + 1
    if half == "fwd":
        want = rs._film_fwd_plain(m, table, ranks, act)
        base = rs._film_fwd_impl(m, table, ranks, act=act)
    else:
        want = rs._film_bwd_dgb_plain(m, table, ranks, act)
        base = rs._film_bwd_dgb_impl(m, table, ranks, act=act)
    film_variant_check(torch, rs, "%s %s" % (half, name), got, want,
                       (m, table, ranks), base, act)


@pytest.mark.parametrize("gaps", ["every", "wide", "some"])
@pytest.mark.parametrize("half,name", [("fwd", n) for n in FWD]
                         + [("dgb", n) for n in DGB])
def test_film_variant_on_a_gapped_stream(dev, half, name, gaps):
    """Nondecreasing ranks with gaps, which K1 and K2 accept: each variant
    leaves the rows without edges at zero and matches its plain version
    and K1 / K2 as on a gap-free stream (v2a's gapped blocks walk as K1
    does instead of summing in their shared window)."""
    m, gb, gbg, ranks = film_inputs(dev, 128, gaps)
    table = gb if half == "fwd" else gbg
    _, fn = _variant(half, name, "elu")
    got = fn(m, table, ranks)
    torch.cuda.synchronize()
    if half == "fwd":
        want = rs._film_fwd_plain(m, table, ranks, "elu")
        base = rs._film_fwd_impl(m, table, ranks, act="elu")
    else:
        want = rs._film_bwd_dgb_plain(m, table, ranks, "elu")
        base = rs._film_bwd_dgb_impl(m, table, ranks, act="elu")
    empty = torch.ones(table.shape[0], dtype=torch.bool, device=dev)
    empty[ranks.long()] = False
    assert int(empty.sum()) > 0
    assert not got[empty].any()
    film_variant_check(torch, rs, "%s %s, %s gaps" % (half, name, gaps), got,
                       want, (m, table, ranks), base, "elu")


def gather_inputs(dev, d, rows, dtype):
    rng = np.random.default_rng(0)
    table, idx, idx_w, starts = rgp.make_inputs(rng, E, d, rows)
    return (torch.from_numpy(table).to(dev, torch.float32).to(dtype),
            *(torch.from_numpy(x).to(dev) for x in (idx, idx_w, starts)))


@pytest.mark.parametrize("d,rows", [(320, 8192), (128, 51472)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["loop", "loop8", "take", "onehot"])
def test_row_gather_matches_plain(dev, variant, dtype, d, rows):
    table, idx, idx_w, starts = gather_inputs(dev, d, rows, dtype)
    counter = "rowgather_" + variant
    before = rs.LAUNCHES[counter]
    if variant == "onehot":
        got = rgp.kernel_onehot(table, idx_w, starts)
        want = rgp._onehot_plain(table, idx_w, starts, 32)
        assert 0 < rgp.zero_share(got) < 1
    else:
        got = getattr(rgp, "kernel_" + variant)(table, idx)
        want = table.index_select(0, idx)
    torch.cuda.synchronize()
    assert rs.LAUNCHES[counter] == before + 1
    check_exact("%s %s D=%d" % (variant, dtype, d), got, want, torch)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_take_clamps_and_onehot_windows(dev, dtype):
    """take clamps out-of-range indices; onehot's rows are zero outside
    its window and the bf16-rounded table row inside it, also for a
    window other than 32 and a table whose window outgrows 48 KB."""
    table, idx, idx_w, starts = gather_inputs(dev, 320, 8192, dtype)
    bad = idx.clone()
    bad[::5] += 8192
    bad[1::7] = -3
    check_exact("take, clamped", rgp.kernel_take(table, bad),
                rgp._take_plain(table, bad), torch)
    for win in (8, 64):
        check_exact("onehot win %d" % win,
                    rgp.kernel_onehot(table, idx_w, starts, win=win),
                    rgp._onehot_plain(table, idx_w, starts, win), torch)


def test_wrappers_refuse(dev):
    """Wrong types and an E that is not a multiple of 2,048 raise, and
    nothing refused is launched."""
    m, gb, gbg, ranks = film_inputs(dev, 128)
    table, idx, idx_w, starts = gather_inputs(dev, 128, 8192, torch.float32)
    before = dict(rs.LAUNCHES)
    with pytest.raises(TypeError):
        ffa._impl_v3(m.float(), gb, ranks, act="relu", group=2)
    with pytest.raises(TypeError):
        ffa._impl_dgb_v4(m, gbg, ranks.long(), act="relu", group=2)
    with pytest.raises(ValueError, match="multiple of 2048"):
        ffa._impl("a", m[:3000], gb, ranks[:3000], act="relu")
    with pytest.raises(ValueError, match="group"):
        ffa._impl_dgb_v3(m, gbg, ranks, act="relu", group=3)
    with pytest.raises(ValueError, match="multiple of 8"):
        ffa._impl("b", m[:, :100], gb[:, :200], ranks, act="relu")
    with pytest.raises(TypeError):
        rgp.kernel_loop(table.half(), idx)
    with pytest.raises(TypeError):
        rgp.kernel_take(table, idx.long())
    with pytest.raises(TypeError):
        rgp.kernel_onehot(table, idx_w, starts.long())
    with pytest.raises(ValueError, match="multiple of 2048"):
        rgp.kernel_loop8(table, idx[:3000])
    assert rs.LAUNCHES == before
