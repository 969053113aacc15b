"""The port's RGAT slice against the JAX package's, on a small QM9 batch
(max_nodes_in_batch 600: n_pad 640, E 10,240 = 5 * 2048) and on random
streams: the plain versions of the four head-major attention kernels (K6a
segsum_t, K6b expand_t, K7a wseg_t, K7b wseg_t_bwd) against the Pallas
kernels in interpret mode, their VJPs, the three receiver softmaxes, the
ranked gather, rgat_apply on its plain and streamed branches, the 2-layer
model (loss, gradients, two RMSProp steps), checkpoints carried both ways
and the CLIs on the CPU.

Both packages prefer a third, fused RGAT branch where its gate holds (it
rounds the source logits to bf16 and is a different function; held
against JAX in tests/test_torch_rgat_fused.py); the tests of the streamed
branch here switch it off in both, as tests/test_ranked_segment.py does.
The CLI test runs in a subprocess, where "auto" takes the default
branch."""

import gzip
import itertools
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.nn import layers as j_layers
from tf_gnn_samples_tpu.ops import edge_ops as j_edge
from tf_gnn_samples_tpu.ops import ranked_segment as j_rs
from tf_gnn_samples_tpu.ops.graph import token_window
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_tpu.utils import registry as j_registry
from tf_gnn_samples_torch.nn import layers as t_layers
from tf_gnn_samples_torch.ops import edge_ops as t_edge
from tf_gnn_samples_torch.ops import ranked_segment as t_rs
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9
from tf_gnn_samples_torch.tools import earlier_designs as t_ed
from tf_gnn_samples_torch.utils import registry as t_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# At 64 columns and more the JAX gather VJP takes its ranked form in
# interpret mode (_ranked_gather_ok), the form the port always takes.
D = 64


@pytest.fixture(autouse=True)
def _force_interpret(monkeypatch):
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(j_rs, "rgat_fused_supported", lambda *a, **k: False)
    monkeypatch.setattr(t_rs, "rgat_fused_supported", lambda *a, **k: False)


def load_task(mod, path, count):
    task = mod.QM9_Task(mod.QM9_Task.default_params())
    return task, task._QM9_Task__load_data(path)[:count]


@pytest.fixture(scope="module")
def qm9():
    """(JAX task, port task, JAX batch, port batch): first 600-node pack."""
    jt, jd = load_task(j_qm9, "data/qm9/valid.jsonl.gz", 200)
    tt, td = load_task(t_qm9, "data/qm9/valid.jsonl.gz", 200)
    jb = next(jt.make_minibatch_iterator(jd, j_base.DataFold.VALIDATION, 600))
    tb = next(tt.make_minibatch_iterator(td, t_base.DataFold.VALIDATION, 600))
    assert jb.graph.n_pad == 640 and tb.graph.flat.rcv_rank.shape[0] == 10240
    return jt, tt, jb, tb


def i32(t):
    return jnp.asarray(t.numpy())


def random_stream(seed, e_tot=4096, n_real=250, frac_pad=0.1):
    """(ranks, table rows, window 0) of a receiver-sorted stream with
    gap-free ranks and a padded tail on the dump rank; the first 50
    receivers have one edge each, the others about 16."""
    rng = np.random.RandomState(seed)
    n_edges = int(e_tot * (1 - frac_pad))
    rcv = np.sort(np.concatenate([
        np.arange(50), rng.randint(50, n_real, size=n_edges - 50)]))
    rank = np.full(e_tot, 0, dtype=np.int32)
    rank[:n_edges] = np.unique(rcv, return_inverse=True)[1]
    rank[n_edges:] = rank[n_edges - 1] + 1
    return torch.from_numpy(rank), t_rs.rank_table_rows(256, 256), 0


def stream(qm9, which):
    """(ranks, table rows, the JAX window) of the QM9 batch's coarse or
    fine ranks, or of a random stream."""
    _, _, jb, tb = qm9
    flat = tb.graph.flat
    if which == "qm9_rcv":
        return (flat.rcv_rank, t_rs.rank_table_rows(tb.graph.n_pad, 256),
                token_window(jb.graph.flat.win_fine))
    if which == "qm9_fine":
        return (flat.tgt_rank, flat.fine_to_flat.shape[0],
                token_window(jb.graph.flat.win_fine))
    return random_stream(17)


STREAMS = ["qm9_rcv", "qm9_fine", "random"]


def assert_order_bound(got, want, terms_abs, counts):
    """Both sides sum the same n bf16-rounded terms of a table entry in
    f32, in two orders: |got - want| <= 2 * gamma_{n-1} * sum|t|, which is
    exact equality for an entry of a single term (the QM9 fine ranks and
    the random stream have such entries, the QM9 receivers do not)."""
    u = 2.0 ** -24
    n1 = np.maximum(counts.astype(np.float64) - 1, 0)
    bound = 2 * (n1 * u / (1 - n1 * u)) * terms_abs.astype(np.float64)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= bound).all(), float((err - bound).max())
    single = np.broadcast_to(counts == 1, got.shape)
    np.testing.assert_array_equal(got[single], want[single])
    return int(single.sum())


def bf16_terms(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def scatter_abs(terms, ranks, rows, axis):
    """Sum of |terms| and number of terms per table entry."""
    r = ranks.numpy()
    shape = list(terms.shape)
    shape[axis] = rows
    out = np.zeros(shape, np.float64)
    idx = [slice(None)] * terms.ndim
    idx[axis] = r
    np.add.at(out, tuple(idx), np.abs(terms))
    counts = np.bincount(r, minlength=rows)
    return out, counts.reshape([-1 if a == axis else 1
                                for a in range(terms.ndim)])


# ---- the four kernels' plain versions against the Pallas kernels --------

@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("which", STREAMS)
def test_segsum_t_plain_matches_pallas(qm9, which, k):
    """K6a: every term rounded to bf16, summed in f32 per (head, rank)."""
    ranks, rows, win = stream(qm9, which)
    m = (3 * np.random.RandomState(k).randn(k, ranks.shape[0])).astype(
        np.float32)
    want = np.asarray(j_rs._segsum_t_impl(
        jnp.asarray(m), i32(ranks), table_rows=rows, block_edges=256,
        win=win))
    got = t_rs._segsum_t_impl(torch.from_numpy(m), ranks, table_rows=rows,
                              block_edges=256, win=win)
    assert got.dtype == torch.float32 and got.shape == (k, rows)
    terms_abs, counts = scatter_abs(bf16_terms(m), ranks, rows, axis=1)
    singles = assert_order_bound(got.numpy(), want, terms_abs, counts)
    assert singles or which == "qm9_rcv"
    assert sum(t_rs.LAUNCHES.values()) == 0  # CPU tensors: plain versions


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("which", STREAMS)
def test_expand_t_plain_matches_pallas_exactly(qm9, which, k):
    """K6b: each edge gets its rank's table column rounded to bf16,
    exactly."""
    ranks, rows, win = stream(qm9, which)
    table = (30 * np.random.RandomState(k + 1).randn(k, rows)).astype(
        np.float32)
    want = j_rs._expand_t_impl(jnp.asarray(table), i32(ranks),
                               block_edges=256, win=win)
    got = t_rs._expand_t_impl(torch.from_numpy(table), ranks)
    assert got.dtype == torch.float32 and got.shape == (k, ranks.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


WSEG_CASES = [(4, 32, 0), (8, 64, 0), (8, 128, 0), (4, 64, 4), (8, 128, 8)]


@pytest.mark.parametrize("k,dim,extra", WSEG_CASES)
@pytest.mark.parametrize("which", ["qm9_rcv", "random"])
def test_wseg_t_plain_matches_pallas(qm9, which, k, dim, extra):
    """K7a: m * rep(w) in f32, rounded to bf16, summed in f32 per rank; the
    `extra` cases feed a [E, D + extra] stream with d_used = D."""
    ranks, rows, win = stream(qm9, which)
    rng = np.random.RandomState(dim + k)
    e = ranks.shape[0]
    m = rng.randn(e, dim + extra).astype(np.float32)
    w = rng.rand(k, e).astype(np.float32)
    kw = dict(table_rows=rows, num_heads=k, block_edges=256, win=win,
              d_used=dim if extra else None)
    want = np.asarray(j_rs._wseg_t_impl(
        jnp.asarray(m).astype(jnp.bfloat16), jnp.asarray(w), i32(ranks),
        **kw))
    tm = torch.from_numpy(m).to(torch.bfloat16)
    got = t_rs._wseg_t_impl(tm, torch.from_numpy(w), ranks, **kw)
    assert got.dtype == torch.float32 and got.shape == (rows, dim)
    terms = bf16_terms(tm[:, :dim].float().numpy()
                       * np.repeat(w.T, dim // k, axis=1))
    terms_abs, counts = scatter_abs(terms, ranks, rows, axis=0)
    singles = assert_order_bound(got.numpy(), want, terms_abs, counts)
    assert singles or which == "qm9_rcv"


@pytest.mark.parametrize("kernel", ["segsum_t_walk", "wseg_t_walk"])
@pytest.mark.parametrize("which", STREAMS)
def test_earlier_k6a_k7a_bodies_take_plain_versions_matching_pallas(
        qm9, which, kernel):
    """tools/earlier_designs.py's K6a and K7a bodies, the baselines of
    their redesign: on CPU tensors they take the plain versions (no
    launch), within the order bound of the Pallas kernels in interpret
    mode; K7a on a [E, D + K] stream read through d_used, as the fused
    RGAT branch feeds it."""
    ranks, rows, win = stream(qm9, which)
    rng = np.random.RandomState(len(kernel) + len(which))
    e, k = ranks.shape[0], 8
    before = dict(t_rs.LAUNCHES)
    if kernel == "segsum_t_walk":
        m = (3 * rng.randn(k, e)).astype(np.float32)
        want = np.asarray(j_rs._segsum_t_impl(
            jnp.asarray(m), i32(ranks), table_rows=rows, block_edges=256,
            win=win))
        got = t_ed.segsum_t_walk(torch.from_numpy(m), ranks,
                                 table_rows=rows)
        assert got.shape == (k, rows)
        terms, axis = bf16_terms(m), 1
    else:
        m = rng.randn(e, D + k).astype(np.float32)
        w = rng.rand(k, e).astype(np.float32)
        kw = dict(table_rows=rows, num_heads=k, d_used=D)
        want = np.asarray(j_rs._wseg_t_impl(
            jnp.asarray(m).astype(jnp.bfloat16), jnp.asarray(w), i32(ranks),
            block_edges=256, win=win, **kw))
        tm = torch.from_numpy(m).to(torch.bfloat16)
        got = t_ed.wseg_t_walk(tm, torch.from_numpy(w), ranks, **kw)
        assert got.shape == (rows, D)
        terms = bf16_terms(tm[:, :D].float().numpy()
                           * np.repeat(w.T, D // k, axis=1))
        axis = 0
    assert got.dtype == torch.float32 and t_rs.LAUNCHES == before
    terms_abs, counts = scatter_abs(terms, ranks, rows, axis=axis)
    singles = assert_order_bound(got.numpy(), want, terms_abs, counts)
    assert singles or which == "qm9_rcv"


@pytest.mark.parametrize("k,dim", [(4, 32), (8, 64), (8, 128)])
@pytest.mark.parametrize("which", ["qm9_rcv", "random"])
def test_wseg_t_bwd_plain_matches_pallas(qm9, which, k, dim):
    """K7b: d_msgs = bf16(g[rank] * rep(w)) exactly; d_w_t, an f32 sum of
    D / K exact products in two orders, within 1e-5 of the row's scale."""
    ranks, rows, win = stream(qm9, which)
    rng = np.random.RandomState(dim * k)
    e = ranks.shape[0]
    m = rng.randn(e, dim).astype(np.float32)
    w = rng.rand(k, e).astype(np.float32)
    g = rng.randn(rows, dim).astype(np.float32)
    jdm, jdw = j_rs._wseg_t_bwd_impl(
        jnp.asarray(m).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(g).astype(jnp.bfloat16), i32(ranks), num_heads=k,
        block_edges=256, win=win)
    tdm, tdw = t_rs._wseg_t_bwd_impl(
        torch.from_numpy(m).to(torch.bfloat16), torch.from_numpy(w),
        torch.from_numpy(g).to(torch.bfloat16), ranks, num_heads=k)
    assert tdm.dtype == torch.bfloat16 and tdm.shape == (e, dim)
    assert tdw.dtype == torch.float32 and tdw.shape == (k, e)
    np.testing.assert_array_equal(tdm.float().numpy(),
                                  np.asarray(jdm.astype(jnp.float32)))
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jdw).max()))


def test_head_major_wrappers_check_shapes():
    ranks = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_rs._segsum_t_impl(torch.zeros(4, 7), ranks, table_rows=4)
    with pytest.raises(ValueError):
        t_rs._expand_t_impl(torch.zeros(4), ranks)
    with pytest.raises(ValueError):  # weights are not [K, E]
        t_rs._wseg_t_impl(torch.zeros(8, 16), torch.zeros(8, 4), ranks,
                          table_rows=4, num_heads=4)
    with pytest.raises(ValueError):  # 16 columns do not split into 3 heads
        t_rs._wseg_t_impl(torch.zeros(8, 16), torch.zeros(3, 8), ranks,
                          table_rows=4, num_heads=3)
    with pytest.raises(ValueError):  # d_used wider than the stream
        t_rs._wseg_t_impl(torch.zeros(8, 16), torch.zeros(4, 8), ranks,
                          table_rows=4, num_heads=4, d_used=32)
    with pytest.raises(ValueError):  # g table of another width
        t_rs._wseg_t_bwd_impl(torch.zeros(8, 16), torch.zeros(4, 8),
                              torch.zeros(4, 8), ranks, num_heads=4)
    assert set(t_rs.LAUNCHES) >= {"segsum_t", "expand_t", "wseg_t",
                                  "wseg_t_bwd"}


# ---- VJPs ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["segsum_t", "expand_t"])
def test_head_major_pair_vjps_match_jax(fn):
    """Forward and VJP of ranked_segment_sum_table_t / ranked_expand_table_t
    (each the other's VJP). Same bf16 terms on both sides, f32 sums in two
    orders: rtol 1e-5, atol 1e-4 (tests/test_ranked_segment.py holds the
    JAX kernels to 2e-2 / 2e-1 against their unrounded oracle)."""
    ranks, rows, _ = random_stream(31)
    rng = np.random.RandomState(7)
    e, k = ranks.shape[0], 4
    if fn == "segsum_t":
        x = rng.randn(k, e).astype(np.float32)
        g = rng.randn(k, rows).astype(np.float32)
        jfn = lambda a: j_rs.ranked_segment_sum_table_t(a, i32(ranks), rows,
                                                        256)
        tfn = lambda a: t_rs.ranked_segment_sum_table_t(a, ranks, rows)
    else:
        x = rng.randn(k, rows).astype(np.float32)
        g = rng.randn(k, e).astype(np.float32)
        jfn = lambda a: j_rs.ranked_expand_table_t(a, i32(ranks), rows, 256)
        tfn = lambda a: t_rs.ranked_expand_table_t(a, ranks, rows)
    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tfn(tx)
    (tdx,) = torch.autograd.grad(tout, tx, torch.from_numpy(g))
    assert tdx.dtype == torch.float32 and tdx.shape == tx.shape
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_segment_sum_t_vjp_matches_jax(dtype):
    """Forward and VJP of ranked_weighted_segment_sum_t under the loss of
    tests/test_ranked_segment.py (sum of squares), for the f32 stream that
    test feeds and the bf16 stream RGAT feeds. d_msgs comes back in the
    stream's dtype and equals JAX's up to the table cotangent's bf16
    rounding, which an f32 sum-order difference of the table can flip:
    2^-8 relative on few entries. JAX's own test allows 5e-2 / 5e-1."""
    ranks, rows, _ = random_stream(31)
    rng = np.random.RandomState(31)
    e, d, k = ranks.shape[0], 64, 4
    m = rng.randn(e, d).astype(np.float32)
    w = rng.rand(k, e).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(mm, ww):
        return jnp.sum(j_rs.ranked_weighted_segment_sum_t(
            mm, ww, i32(ranks), rows, k, 256) ** 2)

    jval, (jgm, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(m).astype(jdt), jnp.asarray(w))
    tm = torch.from_numpy(m).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tval = (t_rs.ranked_weighted_segment_sum_t(tm, tw, ranks, rows, k)
            ** 2).sum()
    tgm, tgw = torch.autograd.grad(tval, (tm, tw))
    assert tgm.dtype == tdt and tgw.dtype == torch.float32
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    jgm = np.asarray(jgm.astype(jnp.float32))
    np.testing.assert_allclose(tgm.float().numpy(), jgm, rtol=2 ** -7,
                               atol=1e-6)
    assert (tgm.float().numpy() != jgm).mean() < 1e-2
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), rtol=1e-3,
                               atol=1e-3 * float(np.abs(jgw).max()))


# ---- the softmaxes ------------------------------------------------------

def softmax_logits(tg, k, seed):
    """[E, K] logits with, beside ordinary receivers: one whose logits all
    clamp low (-80), one with a logit of -70 (clamped) and one with a logit
    of exactly -50 among ordinary ones, and one saturated receiver (+70
    and +50 against -70). The stream has a padded tail."""
    rng = np.random.RandomState(seed)
    ranks = tg.flat.rcv_rank.numpy()
    assert tg.flat.mask.numpy()[-1] == 0.0  # padded tail
    x = (4 * rng.randn(ranks.shape[0], k)).astype(np.float32)
    x[ranks == 3] = -80.0
    x[np.nonzero(ranks == 5)[0][0]] = -70.0
    x[np.nonzero(ranks == 7)[0][0]] = -50.0
    sel = np.nonzero(ranks == 9)[0]
    x[sel[0]], x[sel[1]], x[sel[2:]] = 70.0, 50.0, -70.0
    return x, ranks


SOFTMAXES = {
    "flat": (lambda x, jg: j_edge.segment_softmax_flat(x, jg.flat, jg.n_pad),
             lambda x, tg: t_edge.segment_softmax_flat(x, tg.flat, tg.n_pad)),
    "ranked": (j_edge.segment_softmax_flat_ranked,
               t_edge.segment_softmax_flat_ranked),
    "ranked_t": (lambda x, jg: j_edge.segment_softmax_flat_ranked_t(x.T, jg).T,
                 lambda x, tg: t_edge.segment_softmax_flat_ranked_t(
                     x.t().contiguous(), tg).t()),
}


@pytest.mark.parametrize("name", sorted(SOFTMAXES))
def test_segment_softmaxes_match_jax(qm9, monkeypatch, name):
    """The three receiver softmaxes, values and gradients under a random
    cotangent. The plain one (segment max and sum, interpret mode off on
    the JAX side) differs by f32 sum orders only. The ranked ones divide
    by a denominator that K5b / K6b round to bf16 on both sides; where an
    f32 sum-order difference flips that rounding a whole receiver moves by
    2^-8 relative, so they are held to 2^-7 relative with few entries
    different at all. Padded edges get 0 and the weights of a real
    receiver sum to 1, but for the all-clamped-low receiver of the ranked
    forms: its weights e^-50 / (n e^-50 + 1e-7) vanish on both sides, where
    the max-shifted form gives the uniform distribution.

    At the clamp: a logit of -70 gets no gradient, one of exactly -50
    half of it, as jnp.clip gives (torch.clamp would give all of it). The
    saturated receiver (logits of +70 and +50, denominator 1e22) is left
    out of the ranked gradients' comparison: the reference's division VJP
    squares the denominator, which overflows f32 above 1.8e19, and loses
    the denominator's half of the gradient there; the port's gradient
    there is held to the softmax's own formula."""
    if name == "flat":
        monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", False)
    _, _, jb, tb = qm9
    tg, jg = tb.graph, jb.graph
    k = 4
    x, ranks = softmax_logits(tg, k, seed=3)
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jfn, tfn = SOFTMAXES[name]
    jout, vjp = jax.vjp(lambda a: jfn(a, jg), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    jdx = np.asarray(jdx)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tfn(tx, tg)
    (tdx,) = torch.autograd.grad(tout, tx, torch.from_numpy(g))
    tdx = tdx.numpy()
    got, want = tout.detach().numpy(), np.asarray(jout)
    mask = tg.flat.mask.numpy() > 0
    assert (got[~mask] == 0).all() and np.isfinite(got).all()
    assert np.isfinite(tdx).all()
    if name == "flat":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tdx, jdx, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-30)
        assert (got != want).mean() < 2e-2
        cmp = ranks != 9
        np.testing.assert_allclose(
            tdx[cmp], jdx[cmp], rtol=2 ** -6,
            atol=2 ** -7 * float(np.abs(jdx[cmp]).max()))
        # Its two clamped-high edges weigh 1/2 each; the one at exactly
        # +50 gets 1/2 (the clip) * p * (g - sum_j p_j g_j).
        i70, i50 = np.nonzero(ranks == 9)[0][:2]
        assert (tdx[i70] == 0).all()
        np.testing.assert_allclose(tdx[i50], 0.125 * (g[i50] - g[i70]),
                                   rtol=5e-2, atol=2e-3)
        i70 = np.nonzero(ranks == 5)[0][0]
        assert (tdx[i70] == 0).all() and (jdx[i70] == 0).all()
        # Exactly at the clamp: the same function with torch.clamp in the
        # clip's place gives twice this gradient.
        i50 = np.nonzero(ranks == 7)[0][0]
        assert (np.abs(jdx[i50]) > 0).all()
        np.testing.assert_allclose(tdx[i50], jdx[i50], rtol=2 ** -6)
    sums = np.zeros((ranks.max() + 1, k))
    np.add.at(sums, ranks[mask], got[mask])
    sums = sums[:ranks[mask].max() + 1]
    low = got[ranks == 3]
    if name == "flat":
        np.testing.assert_allclose(low, 1.0 / low.shape[0], rtol=1e-5)
    else:
        assert (low < 1e-12).all()
        sums = np.delete(sums, 3, axis=0)
    np.testing.assert_allclose(sums, 1.0, rtol=2e-2)


# ---- the ranked gather --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_ranked_matches_jax(qm9, dtype):
    """gather_flat_src_ranked: the forward is the clamped row take; the
    backward sums the bf16-rounded cotangent per source row in f32 through
    K5a (same terms on both sides, two sum orders), cast to the table's
    dtype. A table with one row more than the node rows gets a zero row."""
    _, _, jb, tb = qm9
    tf, jf = tb.graph.flat, jb.graph.flat
    rng = np.random.RandomState(8)
    rows = tb.graph.num_edge_types * tb.graph.n_pad
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for extra in (0, 1):
        table = rng.randn(rows + extra, D).astype(np.float32)
        g = rng.randn(tf.src_flat.shape[0], D).astype(np.float32)
        jout, vjp = jax.vjp(
            lambda a: j_edge._gather_ranked(
                a, jf.src_flat, jf.perm_by_src, jf.src_sorted_rank,
                jf.src_to_rank, 256, token_window(jf.win_src)),
            jnp.asarray(table).astype(jdt))
        (jd,) = vjp(jnp.asarray(g).astype(jdt))
        tt = torch.from_numpy(table).to(tdt).requires_grad_(True)
        tout = t_edge.gather_flat_src_ranked(tt, tf)
        (td,) = torch.autograd.grad(tout, tt, torch.from_numpy(g).to(tdt))
        assert td.dtype == tdt and td.shape == tt.shape
        np.testing.assert_array_equal(
            tout.detach().float().numpy(), np.asarray(jout.astype(jnp.float32)))
        np.testing.assert_allclose(
            td.float().numpy(), np.asarray(jd.astype(jnp.float32)),
            rtol=2 ** -7 if dtype == "bfloat16" else 1e-5, atol=1e-5)
        if extra:
            assert (td[-1] == 0).all()


# ---- the layer ----------------------------------------------------------

def _layer_inputs(tg, dim, seed):
    rng = np.random.RandomState(seed)
    L = tg.num_edge_types
    # Scaled so that the logits stay far below 44: above it the
    # reference's softmax gradient overflows (see the softmax test).
    params = {"W": (0.1 * rng.randn(L, dim, dim)).astype(np.float32),
              "att": (0.3 * rng.randn(L, 2 * dim)).astype(np.float32)}
    h = rng.randn(tg.n_pad, dim).astype(np.float32)
    w = rng.randn(tg.n_pad, dim).astype(np.float32)
    return params, h, w


def _run_rgat(pkg, graph, params, h, w, **kw):
    if pkg == "jax":
        def loss(p, hh):
            out = j_layers.rgat_apply(p, graph, hh, **kw)
            return jnp.sum(out * w), out

        (_, out), (gp, gh) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, h)
        return [np.asarray(a) for a in (out, gp["W"], gp["att"], gh)]
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    out = t_layers.rgat_apply(tp, graph, th, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return [a.detach().numpy() for a in (out, tp["W"].grad, tp["att"].grad,
                                         th.grad)]


@pytest.mark.parametrize("dim,heads", [(64, 8), (128, 8), (64, 4)])
@pytest.mark.parametrize("branch", ["plain", "streamed"])
def test_rgat_layer_matches_jax(qm9, monkeypatch, branch, dim, heads):
    """Output and the gradients with respect to W, att and h of a
    2-timestep RGAT layer on the QM9 batch.

    The plain branch ("segment", interpret mode off on the JAX side: f32
    gathers, segment max and sums) differs by f32 matmul and sum orders:
    within 1e-5 of each tensor's largest value.

    The streamed branch ("pallas": the bf16 message stream, K6 and K7 and
    the ranked gather on both sides) rounds at the same places on both
    sides, but a value whose f32 bits differ may round to the neighbouring
    bf16 number, 2^-8 of itself, and the softmax denominator carries such
    a flip to a whole receiver. Held to 1e-3 relative norm and 2^-8 of the
    tensor's largest value per entry (measured: <= 5.6e-4 and <= 2.5e-3); a
    wrong kernel or rounding point moves every entry."""
    streamed = branch == "streamed"
    if not streamed:
        monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", False)
    _, _, jb, tb = qm9
    assert t_layers.rgat_streamed_branch(tb.graph, dim, heads, "pallas")
    assert not t_layers.rgat_streamed_branch(tb.graph, dim, heads, "segment")
    assert not t_layers.rgat_streamed_branch(tb.graph, dim, 7, "auto")
    params, h, w = _layer_inputs(tb.graph, dim, seed=dim + heads)
    kw = dict(num_heads=heads, activation_function="elu", num_timesteps=2,
              aggregation_strategy="pallas" if streamed else "segment")
    before = dict(t_rs.LAUNCHES)
    got = _run_rgat("torch", tb.graph, params, h, w, **kw)
    want = _run_rgat("jax", jb.graph, params, h, w, **kw)
    assert t_rs.LAUNCHES == before  # CPU tensors: plain versions only
    for name, a, b in zip(("out", "dW", "datt", "dh"), got, want):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        scale = float(np.abs(b).max())
        if streamed:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel < 1e-3, (name, rel)
            np.testing.assert_allclose(a, b, rtol=0, atol=2 ** -8 * scale,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=name)


def test_rgat_init_matches_jax_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    got = t_layers.rgat_init(gen, 5, 64, num_heads=8)
    want = j_layers.rgat_init(jax.random.PRNGKey(0), 5, 64, num_heads=8)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    limit = np.sqrt(6.0 / (4 * 64))
    for att in (got["att"].numpy(), np.asarray(want["att"])):
        assert np.abs(att).max() <= limit and np.abs(att).max() > 0.9 * limit
        assert abs(att.mean()) < 0.05 * limit
    assert "rgat" in t_layers.LAYERS


# ---- the model ----------------------------------------------------------

def small_params(**extra):
    """The tuned QM9 RGAT hypers cut to hidden 64 and 2 layers, with
    dropout off (the two packages' random streams cannot match)."""
    with open(os.path.join(ROOT, "tf_gnn_samples_torch", "default_hypers",
                           "QM9_RGAT.json")) as f:
        hypers = json.load(f)["model_params"]
    params = j_model.RGAT_Model.default_params()
    params.update(hypers)
    params.update({"hidden_size": D, "graph_num_layers": 2,
                   "graph_layer_input_dropout_keep_prob": 1.0,
                   "max_nodes_in_batch": 600})
    params.update(extra)
    return params


def test_hypers_are_a_copy_and_defaults_match():
    names = ["tf_gnn_samples_%s/default_hypers/QM9_RGAT.json" % p
             for p in ("tpu", "torch")]
    with open(os.path.join(ROOT, names[0])) as a, \
            open(os.path.join(ROOT, names[1])) as b:
        assert a.read() == b.read()
    # The JAX package's defaults also carry its parallelism switches.
    defaults = t_model.RGAT_Model.default_params()
    jdefaults = j_model.RGAT_Model.default_params()
    assert defaults == {k: jdefaults[k] for k in defaults}
    assert defaults["num_heads"] == 4
    assert t_model.RGAT_Model.name({}) == j_model.RGAT_Model.name({}) == "RGAT"


@pytest.mark.parametrize("strategy", ["auto", "segment"])
def test_model_loss_grads_and_rmsprop_steps_match_jax(qm9, monkeypatch,
                                                      tmp_path, strategy):
    """Loss, every parameter gradient and two clipped RMSProp steps of the
    2-layer, 8-head model, weights carried by params_from_jax. "auto" takes
    the streamed branch on both sides (interpret mode on), "segment" the
    plain one (interpret mode off). Compared by norms: on the plain branch
    f32 matmul and sum orders differ (loss 1e-5, gradients 1e-4 relative);
    on the streamed branch a streamed value may also round to the
    neighbouring bf16 number (loss 1e-4, gradients 1e-3)."""
    streamed = strategy == "auto"
    if not streamed:
        monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", False)
    jt, tt, jb, tb = qm9
    params = small_params(aggregation_strategy=strategy)
    jm = j_model.RGAT_Model(dict(params), jt, "j", str(tmp_path))
    tm = t_model.RGAT_Model(dict(params), tt, "t", str(tmp_path),
                            device="cpu")
    jflat0 = j_model.flatten_params(jm.model_params_tree)
    tm.load_weights(jflat0)
    assert t_model.params_to_jax(tm.model_params_tree).keys() == jflat0.keys()
    assert jflat0["prop/layers/0/gnn/att"].shape == (jt.num_edge_types, 2 * D)
    jdev = jm._device_batch(jb)
    tdev = t_model.batch_to_device(tb, CPU)

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm._forward(p, jdev, None), has_aux=True)(
            jm.model_params_tree)
    tloss, _ = tm._forward(tm.model_params_tree, tdev, None)
    tgrads = torch.autograd.grad(tloss, tm._leaves())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-4 if streamed else 1e-5)
    jflat = j_model.flatten_params(jgrads)
    names = list(t_model.flatten_params(tm.model_params_tree))
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, tgrads):
        rel = np.linalg.norm(g.numpy() - jflat[name]) / max(
            np.linalg.norm(jflat[name]), 1e-30)
        assert rel < (1e-3 if streamed else 1e-4), (name, rel)

    step = jm._make_train_step()
    jp, jo = jm.model_params_tree, jm.opt_state
    for i in range(2):
        jp, jo, _ = step(jp, jo, jax.random.PRNGKey(i), jdev)
        tm._train_step(tdev)
    assert tm.opt_state.step == int(jo.step) == 2
    jflat = j_model.flatten_params(jp)
    tflat = t_model.params_to_jax(tm.model_params_tree)
    for name in jflat:
        # One RMSProp step moves a weight by ~lr / sqrt(0.02) = 4e-3; an
        # entry whose gradient is near zero takes a step set by the
        # gradient's last digits.
        np.testing.assert_allclose(tflat[name], jflat[name], rtol=1e-5,
                                   atol=1e-3, err_msg=name)


def write_subset(src, dst, count):
    with gzip.open(src, "rt") as fin, gzip.open(dst, "wt") as fout:
        fout.writelines(itertools.islice(fin, count))


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """A data directory with the first graphs of each bundled QM9 fold."""
    d = tmp_path_factory.mktemp("qm9_small_rgat")
    for fold, count in (("train", 300), ("valid", 100), ("test", 150)):
        write_subset(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                     str(d / (fold + ".jsonl.gz")), count)
    return d


def eval_loss(model, base, path):
    data = model.task.load_eval_data_from_path(path)
    loss, metrics, graphs, _, _, _ = model._run_epoch(
        "Test", data, base.DataFold.TEST, quiet=True)
    mae = sum(float(m["abs_err_task0"]) for m in metrics) / graphs
    return loss, mae, graphs


def test_checkpoints_cross_packages(qm9, small_data, monkeypatch, tmp_path):
    """A pickle the JAX package wrote loads into the port
    (registry.restore) and gives the same test loss and MAE; the port's
    pickle carries the same names and shapes (W [L, D, D], att [L, 2D])
    and loads into the JAX package. Both evaluate on the plain branch
    (aggregation_strategy "segment" from the pickle), where only f32
    orders differ."""
    monkeypatch.setattr(j_rs, "_FORCE_INTERPRET", False)
    jt = qm9[0]
    test_file = str(small_data / "test.jsonl.gz")
    jm = j_model.RGAT_Model(small_params(aggregation_strategy="segment"), jt,
                            "j", str(tmp_path))
    jm.save_model(str(tmp_path / "jax.pickle"))
    jloss = eval_loss(jm, j_base, test_file)

    tm = t_registry.restore(str(tmp_path / "jax.pickle"), str(tmp_path),
                            device="cpu")
    assert isinstance(tm, t_model.RGAT_Model)
    tloss = eval_loss(tm, t_base, test_file)
    assert tloss[2] == jloss[2] == 150
    np.testing.assert_allclose(tloss[:2], jloss[:2], rtol=1e-5)

    tm.save_model(str(tmp_path / "torch.pickle"))
    with open(tmp_path / "torch.pickle", "rb") as f:
        saved = pickle.load(f)
    assert saved["model_class"] == "RGAT"
    jflat = j_model.flatten_params(jm.model_params_tree)
    assert saved["weights"].keys() == jflat.keys()
    for k, v in saved["weights"].items():
        assert v.shape == jflat[k].shape and v.dtype == np.float32, k
    jm2 = j_registry.restore(str(tmp_path / "torch.pickle"), str(tmp_path))
    np.testing.assert_allclose(eval_loss(jm2, j_base, test_file)[:2],
                               jloss[:2], rtol=1e-5)


@pytest.mark.parametrize("alias", ["RGAT", "rgat", "rgat_model"])
def test_registry_resolves_rgat(alias):
    got, extra = t_registry.name_to_model_class(alias)
    assert got is t_model.RGAT_Model and extra == {}


@pytest.mark.parametrize("strategy,branch", [("segment", "plain"),
                                             ("auto", "streamed")])
def test_train_and_test_clis(small_data, tmp_path, strategy, branch):
    """`python -m tf_gnn_samples_torch.train RGAT QM9 --device cpu` at 2
    layers writes the Train/Valid log lines and a best-model pickle that
    `python -m tf_gnn_samples_torch.test --device cpu` evaluates, on the
    kernel branch "auto" picks (every pack's edge stream is padded to
    whole 2048-edge rows, so the kernels' plain versions run; the case
    keeps the name it had when that branch was the streamed one) and on
    the plain one. Without --device cpu the
    CLI raises where there is no GPU."""
    overrides = json.dumps({"max_epochs": 1, "hidden_size": 16,
                            "graph_num_layers": 2,
                            "max_nodes_in_batch": 2000,
                            "aggregation_strategy": strategy})
    cmd = [sys.executable, "-m", "tf_gnn_samples_torch.train", "RGAT", "QM9",
           "--data-path", str(small_data), "--result-dir", str(tmp_path),
           "--quiet", "--model-param-overrides", overrides]
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for fold in ("Train", "Valid"):
        m = re.search(r"^ %s: loss: (\S+) \|\| MAEs: " % fold, out.stdout,
                      re.M)
        assert m and np.isfinite(float(m.group(1))), out.stdout
    pickles = list(tmp_path.glob("QM9_RGAT_*_best_model.pickle"))
    assert len(pickles) == 1
    out = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
         "--result-dir", str(tmp_path), "--quiet", str(pickles[0]),
         str(small_data / "test.jsonl.gz")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^Loss \d+\.\d{5} on 150 graphs$", out.stdout, re.M)
    if branch == "plain" and not torch.cuda.is_available():
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0 and "No CUDA device" in out.stderr
