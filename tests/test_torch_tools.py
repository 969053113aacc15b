"""The port's K16 harnesses (tf_gnn_samples_torch/tools/) against the JAX
tools they port (tools/film_fwd_ab.py, tools/rowgather_prof.py), on the
CPU: each port function runs its plain version, each JAX function its
Pallas kernel in interpret mode, on the same numpy-made inputs. The FiLM
variants at E = 4,096 (two 2,048-edge steps), D = 32; the row gathers at
E = 4,096, D = 128, 512 table rows."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tf_gnn_samples_torch.tools import film_fwd_ab as t_film
from tf_gnn_samples_torch.tools import rowgather_prof as t_rg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    """tools/<name>.py, which is not a package, by file path."""
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


j_film = _load_tool("film_fwd_ab")
j_rg = _load_tool("rowgather_prof")

E, D_FILM, D_RG, ROWS, WIN = 4096, 32, 128, 512, 32
# Both sides sum the same bf16-rounded terms in f32 in different orders
# (one-hot MXU dots against index_add_), as tests/test_torch_film.py
# TERMS: a few f32 ulps of a row's sum; a term rounded to another bf16
# value would be off by 2^-8 of itself.
TERMS = dict(rtol=1e-5, atol=1e-5)


def bf16_pair(x):
    """The same bf16 values for both packages (both round to nearest)."""
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


@pytest.fixture(scope="module")
def film_inputs():
    ranks = t_film.make_stream(E, E // 16)
    assert np.array_equal(ranks, np.asarray(j_film.make_stream(E, E // 16)))
    n_groups = int(ranks[-1]) + 1
    rows = t_film.rs.rank_table_rows(n_groups + 1, 256)
    assert rows == j_film.rs.rank_table_rows(n_groups + 1, 256)
    m, gb, gbg = t_film.make_inputs(E, D_FILM, rows)
    return ranks, bf16_pair(m), bf16_pair(gb), bf16_pair(gbg)


def windows_hold(ranks, edges, win):
    """Whether every `edges`-edge block's ranks lie in [start, start + win)
    of its aligned start (the first rank with its low 3 bits cleared): the
    window a JAX variant keeps, outside of which it drops edges."""
    blocks = ranks.reshape(-1, edges)
    start = blocks[:, 0] & ~7
    return bool(((blocks.max(axis=1) - start) < win).all())


# (name, JAX call, port call, table, window checks: (edges, rows) pairs)
FILM_CASES = [
    ("v2a", lambda m, t, r, act: j_film._impl(
        j_film._fwd_kernel_v2a, "a", m, t, r, block_edges=256, act=act,
        win=WIN),
     lambda m, t, r, act: t_film._impl("a", m, t, r, act=act), "gb",
     # the step's last 32-row sub-window ends inside its 256-row scratch
     ((256, WIN), (2048, 256 - WIN + 8))),
    ("v2b", lambda m, t, r, act: j_film._impl(
        j_film._fwd_kernel_v2b, "b", m, t, r, block_edges=256, act=act,
        win=WIN),
     lambda m, t, r, act: t_film._impl("b", m, t, r, act=act), "gb",
     ((256, WIN), (2048, 256))),
] + [
    ("v3 g=%d" % g, lambda m, t, r, act, g=g: j_film._impl_v3(
        m, t, r, block_edges=256, act=act, win=WIN, group=g),
     lambda m, t, r, act, g=g: t_film._impl_v3(m, t, r, act=act, group=g),
     "gb", ((256 * g, WIN * g),))
    for g in (2, 4, 8)
] + [
    ("dgb v3 g=%d" % g, lambda m, t, r, act, g=g: j_film._impl_dgb_v3(
        m, t, r, block_edges=256, act=act, win=WIN, group=g),
     lambda m, t, r, act, g=g: t_film._impl_dgb_v3(m, t, r, act=act,
                                                   group=g),
     "gbg", ((256 * g, WIN * g),))
    for g in (2, 4, 8)
] + [
    ("dgb v4 g=%d" % g, lambda m, t, r, act, g=g: j_film._impl_dgb_v4(
        m, t, r, block_edges=256, act=act, win=WIN, group=g),
     lambda m, t, r, act, g=g: t_film._impl_dgb_v4(m, t, r, act=act,
                                                   group=g),
     "gbg", ((256 * g, WIN * g),))
    for g in (2, 4)
]


# Every case with relu (the harness's activation); elu once per kernel body.
FILM_PARAMS = [pytest.param(c, "relu", id=c[0] + "-relu") for c in FILM_CASES]
FILM_PARAMS += [pytest.param(c, "elu", id=c[0] + "-elu") for c in FILM_CASES
                if c[0] in ("v2a", "v2b", "v3 g=2", "dgb v3 g=2",
                            "dgb v4 g=2")]


@pytest.mark.parametrize("case,act", FILM_PARAMS)
def test_film_variants_match_pallas(film_inputs, case, act):
    """Each FiLM variant's plain version against the JAX variant's Pallas
    kernel on inputs where the JAX windows hold (v2a also keeps each
    256-edge sub-block's 32-row window inside its step's 256-row
    scratch)."""
    name, jax_fn, port_fn, which, windows = case
    ranks, (jm, tm), gb, gbg = film_inputs
    for edges, win in windows:
        assert windows_hold(ranks, edges, win), (name, edges, win)
    jt, tt = gb if which == "gb" else gbg
    want = np.asarray(jax_fn(jm, jt, jnp.asarray(ranks), act))
    got = port_fn(tm, tt, torch.from_numpy(ranks), act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TERMS)


def _jax_gather(body, table, idx, *extra, be=256, win=WIN):
    """A row-gather body of the JAX tool through pl.pallas_call in
    interpret mode, with the tool's own BlockSpecs (its jitted wrappers
    ask for the TPU)."""
    e, d = idx.shape[0], table.shape[1]
    out_spec = pl.BlockSpec((j_rg.STEP, d), lambda c: (c, 0),
                            memory_space=pltpu.VMEM)
    out_shape = jax.ShapeDtypeStruct((e, d), table.dtype)
    if body is j_rg._onehot_kernel:
        (starts,) = extra
        return pl.pallas_call(
            lambda *refs: body(*refs, be=be, win=win),
            grid=(e // j_rg.STEP,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                      pl.BlockSpec((j_rg.STEP // be, be), lambda c: (c, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=out_spec, out_shape=out_shape, interpret=True,
        )(starts, idx.reshape(e // be, be), table)
    idx_space = pltpu.VMEM if body is j_rg._take_kernel else pltpu.SMEM
    return pl.pallas_call(
        body, grid=(e // j_rg.STEP,),
        in_specs=[pl.BlockSpec((j_rg.STEP,), lambda c: (c,),
                               memory_space=idx_space),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=out_spec, out_shape=out_shape, interpret=True,
    )(idx, table)


def rowgather_inputs(dname, e=E, d=D_RG, rows=ROWS):
    """The port's inputs of table type `dname` (bf16 drawn first, as the
    tools do), as (jax, torch) pairs; the f64 table is rounded through
    f32 on both sides."""
    rng = np.random.default_rng(0)
    for name in t_rg.DTYPES:
        table, idx, idx_w, starts = t_rg.make_inputs(rng, e, d, rows)
        if name == dname:
            break
    table = table.astype(np.float32)
    jtype, ttype = ((jnp.bfloat16, torch.bfloat16) if dname == "bf16"
                    else (jnp.float32, torch.float32))
    pair = lambda x: (jnp.asarray(x), torch.from_numpy(x))
    return ((jnp.asarray(table).astype(jtype),
             torch.from_numpy(table).to(ttype)),
            pair(idx), pair(idx_w), pair(starts))


@pytest.mark.parametrize("dname", ["bf16", "f32"])
@pytest.mark.parametrize("variant", ["loop", "loop8", "take", "onehot"])
def test_row_gathers_match_pallas(variant, dname):
    """Each row gather's plain version against the JAX tool's kernel body,
    exactly (uniform indices; onehot on the tool's windowed stream)."""
    (jt, tt), (ji, ti), (jw, tw), (js, ts) = rowgather_inputs(dname)
    body = {"loop": j_rg._loop_kernel, "loop8": j_rg._loop8_kernel,
            "take": j_rg._take_kernel, "onehot": j_rg._onehot_kernel}[variant]
    if variant == "onehot":
        want = _jax_gather(body, jt, jw, js)
        got = t_rg.kernel_onehot(tt, tw, ts, win=WIN)
    else:
        want = _jax_gather(body, jt, ji)
        got = getattr(t_rg, "kernel_" + variant)(tt, ti)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tt.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_take_clips_out_of_range_indices():
    """kernel_take clamps indices to [0, rows) as jnp.take(mode="clip")."""
    (jt, tt), (ji, ti), _, _ = rowgather_inputs("f32")
    ti = ti.clone()
    ti[::7] += ROWS
    ti[3::11] = -5
    want = np.asarray(_jax_gather(j_rg._take_kernel, jt, jnp.asarray(ti)))
    np.testing.assert_array_equal(t_rg.kernel_take(tt, ti).numpy(), want)


def test_onehot_zero_rows_on_the_tools_stream():
    """The JAX tool's windowed stream is not sorted within a block, so
    onehot zeroes every row whose index falls below its block's start: at
    E = 4,096, D = 128, 8,192 rows and seed 0, 1,059 of 4,096 rows (25.9 %)
    with the f32 table and 933 (22.8 %) with the bf16 one, on both sides;
    every other row is the bf16-rounded table row, which for an f32 table
    is not the f32 row."""
    (jt, tt), _, (jw, tw), (js, ts) = rowgather_inputs("f32", rows=8192)
    got = t_rg.kernel_onehot(tt, tw, ts)
    want = np.asarray(_jax_gather(j_rg._onehot_kernel, jt, jw, js))
    np.testing.assert_array_equal(got.numpy(), want)
    zero = (got == 0).all(dim=1)
    local = tw - ts.repeat_interleave(256)
    assert torch.equal(zero, local < 0)
    assert local.min() < 0 and local.max() < WIN
    exact = tt.index_select(0, tw)
    assert torch.equal(got[~zero], exact[~zero].to(torch.bfloat16).float())
    assert not torch.equal(got[~zero], exact[~zero])
    (_, tb), _, (_, twb), (_, tsb) = rowgather_inputs("bf16", rows=8192)
    share = t_rg.zero_share(t_rg.kernel_onehot(tb, twb, tsb))
    assert int(zero.sum()) == 1059
    assert share == 933 / 4096, share


TAIL = 3000  # edges: not a multiple of 2,048
TAIL_CALLS = {
    "v2a": lambda m, gb, gbg, t, r: t_film._impl("a", m, gb, r, act="relu"),
    "v2b": lambda m, gb, gbg, t, r: t_film._impl("b", m, gb, r, act="relu"),
    "v3": lambda m, gb, gbg, t, r: t_film._impl_v3(m, gb, r, act="relu",
                                                   group=4),
    "dgb_v3": lambda m, gb, gbg, t, r: t_film._impl_dgb_v3(
        m, gbg, r, act="relu", group=2),
    "dgb_v4": lambda m, gb, gbg, t, r: t_film._impl_dgb_v4(
        m, gbg, r, act="relu", group=2),
    "loop": lambda m, gb, gbg, t, r: t_rg.kernel_loop(t, r),
    "loop8": lambda m, gb, gbg, t, r: t_rg.kernel_loop8(t, r),
    "take": lambda m, gb, gbg, t, r: t_rg.kernel_take(t, r),
    "onehot": lambda m, gb, gbg, t, r: t_rg.kernel_onehot(t, r, r[::256]),
}


@pytest.mark.parametrize("name", sorted(TAIL_CALLS))
def test_tail_edges_raise(name):
    """An E that is not a multiple of 2,048 raises: the JAX tools' grids
    of E // 2,048 steps would leave its tail rows unwritten."""
    m = torch.zeros((TAIL, D_FILM), dtype=torch.bfloat16)
    gb, gbg = (torch.zeros((64, k * D_FILM), dtype=torch.bfloat16)
               for k in (2, 3))
    table = torch.zeros((64, D_FILM))
    ranks = torch.zeros(TAIL, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 2048"):
        TAIL_CALLS[name](m, gb, gbg, table, ranks)


def test_harnesses_run_on_the_cpu(capsys):
    """Both harnesses' `main` with --device cpu at a tiny size run the
    plain versions and print their correctness lines."""
    t_film.main(["4096", "16", "--device", "cpu"])
    t_rg.main(["4096", "32", "256", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("v2a", "v2b", "v3 g=2", "v3 g=4", "v3 g=8"):
        assert "fwd %s max rel err vs K1 film_fwd: 0.00e+00" % name in out
    for name in ("v3 g=2", "v3 g=4", "v3 g=8", "v4 g=2", "v4 g=4"):
        assert "dgb %s max rel err vs K2 film_bwd_dgb: 0.00e+00" % name in out
    for dname in ("bf16", "f32"):
        assert "--- dtype=%s E=4096 D=32 rows=256 (cpu) ---" % dname in out
    assert out.count("of the output rows are zero") == 2
    assert "times need the card" in out
