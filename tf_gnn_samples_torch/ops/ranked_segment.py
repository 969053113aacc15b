"""Rank-table kernels (counterpart of tf_gnn_samples_tpu/ops/ranked_segment.py:
the ranked segment-sum / expand pair, the fused GNN-FiLM kernels and the
head-major attention kernels of RGAT).

The flat edge stream (ops/graph.py FlatEdges) is receiver-sorted with
gap-free coarse (receiver) and fine (receiver, type) ranks; its src-sorted
view has gap-free src ranks. Nine CUDA kernels (csrc/) work over those
sorted ranks:

* K5a `_segsum_table_impl`: table[r] = sum bf16(m_e) (the ranked
  segment-sum of RGCN/GGNN aggregation, and the VJP of K5b);
* K5b `_expand_impl`: out[e] = bf16(table[rank_e]) (the VJP of K5a);
* K1 `_film_fwd_impl`: table[r] = sum bf16(act(gamma[r] * m_e + beta[r]));
* K2 `_film_bwd_dgb_impl`: d_gamma | d_beta of K1 in receiver order;
* K3 `_film_src_bwd_impl`: dt over the src-sorted stream, recomputing z;
* K6a `_segsum_t_impl`: table_t[k, r] = sum bf16(m_t[k, e]), head-major
  [K, E] -> [K, R] (the RGAT softmax denominator, and the VJP of K6b);
* K6b `_expand_t_impl`: out[k, e] = bf16(table_t[k, rank_e]) (the VJP of
  K6a);
* K7a `_wseg_t_impl`: table[r] = sum bf16(m_e * rep(w_t[:, e])), the
  attention-weighted aggregation with head-major [K, E] weights;
* K7b `_wseg_t_bwd_impl`: d_msgs and d_w_t of K7a.

Each wrapper launches its kernel for CUDA tensors and raises on anything
the kernel does not take; it runs the plain PyTorch version beside it only
for tensors on the CPU. `LAUNCHES` counts kernel launches, one per wrapper
call that reached its kernel.

Numerics follow the TPU kernels' rounding points: z is computed in f32
from bf16 operands, and every summed term (the message in K5a, the
activation in K1, m * dz and dz in K2, act'(z) * C in K3, the head-major
term in K6a, the weighted message in K7a) is rounded to bf16 before its
f32 sum; K5b and K6b round each table value to bf16; K7b writes d_msgs in
bf16 and keeps d_w_t in f32. The kernels sum in stream order with atomics
at chunk seams, so their sums differ from run to run in the last bits; the
terms do not.
"""

import math
from typing import Dict

import torch

from . import cuda_build


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


# Edges per grid row of the JAX package's kernels: the ranked paths take
# streams of a whole number of rows (tasks/base.py pads edge blocks to it).
STEP = 2048


def rank_table_rows(n_pad: int, block_edges: int) -> int:
    """Static COARSE rank-table height: receiver ranks are gap-free over
    distinct receivers (<= n_pad real + 1 dump), plus the JAX package's
    window slack rows (kept so both packages index alike)."""
    return _ceil_mult(n_pad + 1, 8) + block_edges + 8


def ranked_supported(num_edges: int) -> bool:
    """Whether the ranked segment-sum / expand pair applies to a stream of
    `num_edges`: the JAX package's condition of a whole number of STEP-edge
    rows. Its VMEM budget term is dropped: the CUDA kernels keep no table
    on chip, so neither the width nor the table height limits them."""
    return num_edges >= STEP and num_edges % STEP == 0


def fine_rank_table_rows(n_pad: int, num_edge_types: int, num_edges: int,
                         block_edges: int) -> int:
    """Static FINE rank-table height: (receiver, type) group ranks are
    gap-free over distinct groups (<= min(L * (n_pad + 1), E)), plus the
    JAX package's window slack rows (kept so both packages index alike)."""
    groups = min(num_edge_types * (n_pad + 1), num_edges)
    return _ceil_mult(groups, 8) + block_edges + 8


def src_rank_table_rows(t_rows: int, num_edges: int,
                        block_edges: int = 256) -> int:
    """Static SRC rank-table height for the source-sorted stream: (type,
    sender) group ranks over <= min(t_rows + 1 dump, E) groups plus slack;
    `t_rows` is the type-stacked node-table height L * n_pad."""
    return _ceil_mult(min(t_rows + 1, num_edges), 8) + block_edges + 8


# ---- activations: (act, act') pairs, as the JAX package's _ACTS ----------

def _erf_approx(x):
    """Abramowitz-Stegun 7.1.26 (max abs err 1.5e-7), the JAX package's
    erf for the FiLM kernels; the CUDA kernels use the same polynomial."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = 1.0 - poly * torch.exp(-ax * ax)
    return torch.sign(x) * y


def _elu(z):
    return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)


def _delu(z):
    return torch.where(z > 0, 1.0, torch.exp(torch.clamp(z, max=0.0)))


_ACTS = {
    "linear": (lambda z: z, lambda z: torch.ones_like(z)),
    "relu": (lambda z: torch.clamp(z, min=0.0),
             lambda z: (z > 0).to(torch.float32)),
    # alpha=0.2: the tf.nn.leaky_relu default the reference relies on.
    "leaky_relu": (lambda z: torch.where(z > 0, z, 0.2 * z),
                   lambda z: torch.where(z > 0, 1.0, 0.2)),
    "elu": (_elu, _delu),
    "tanh": (torch.tanh, lambda z: 1.0 - torch.tanh(z) ** 2),
    # erf formulation through _erf_approx, not the tanh approximation.
    "gelu": (
        lambda z: 0.5 * z * (1.0 + _erf_approx(z * (2.0 ** -0.5))),
        lambda z: (0.5 * (1.0 + _erf_approx(z * (2.0 ** -0.5)))
                   + z * torch.exp(-0.5 * z * z)
                   * (1.0 / math.sqrt(2.0 * math.pi))),
    ),
}

# Activation ids of the CUDA kernels (csrc/film_common.cuh enum Act).
ACT_IDS = {"linear": 0, "relu": 1, "leaky_relu": 2, "elu": 3, "tanh": 4,
           "gelu": 5}


def film_act_supported(name: str) -> bool:
    return name.lower() in _ACTS


# ---- kernels and their plain versions ---------------------------------

LAUNCHES: Dict[str, int] = {"segsum": 0, "expand": 0, "film_fwd": 0,
                            "film_bwd_dgb": 0, "film_src_bwd": 0,
                            "segsum_t": 0, "expand_t": 0, "wseg_t": 0,
                            "wseg_t_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bf16_terms(x):
    """Round per-edge terms to bf16, then widen for the f32 sum."""
    return x.to(torch.bfloat16).to(torch.float32)


def _segsum_plain(msgs, ranks, table_rows):
    out = torch.zeros((table_rows, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, ranks, _bf16_terms(msgs))


def _expand_plain(table, ranks):
    return _bf16_terms(table).index_select(0, ranks)


def _film_fwd_plain(msgs, gb_table, ranks, act):
    d = msgs.shape[1]
    gb = gb_table.index_select(0, ranks).to(torch.float32)
    z = gb[:, :d] * msgs.to(torch.float32) + gb[:, d:]
    out = torch.zeros((gb_table.shape[0], d), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, ranks, _bf16_terms(_ACTS[act][0](z)))


def _film_bwd_dgb_plain(msgs, gbg_table, ranks, act):
    d = msgs.shape[1]
    v = gbg_table.index_select(0, ranks).to(torch.float32)
    m = msgs.to(torch.float32)
    dz = _ACTS[act][1](v[:, :d] * m + v[:, d:2 * d]) * v[:, 2 * d:]
    terms = torch.cat([_bf16_terms(m * dz), _bf16_terms(dz)], dim=1)
    out = torch.zeros((gbg_table.shape[0], 2 * d), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, ranks, terms)


def _film_src_bwd_plain(gcb_src, t_ranked, ranks, table_rows, act):
    d = t_ranked.shape[1]
    m = t_ranked.index_select(0, ranks).to(torch.float32)
    gcb = gcb_src.to(torch.float32)
    z = gcb[:, :d] * m + gcb[:, d:2 * d]
    out = torch.zeros((table_rows, d), dtype=torch.float32,
                      device=gcb_src.device)
    return out.index_add_(0, ranks,
                          _bf16_terms(_ACTS[act][1](z) * gcb[:, 2 * d:]))


def _segsum_t_plain(msgs_t, ranks, table_rows):
    out = torch.zeros((msgs_t.shape[0], table_rows), dtype=torch.float32,
                      device=msgs_t.device)
    return out.index_add_(1, ranks, _bf16_terms(msgs_t))


def _expand_t_plain(table_t, ranks):
    return _bf16_terms(table_t).index_select(1, ranks)


def _head_replicate(w_t, dim):
    """[K, E] head-major per-head scalars -> [E, D] with each head's value
    repeated over its D / K columns (what the JAX package's
    _head_replicate_matrix contraction computes, exactly)."""
    return w_t.t().repeat_interleave(dim // w_t.shape[0], dim=1)


def _wseg_t_plain(msgs, w_t, ranks, table_rows, d_used=None):
    dim = d_used or msgs.shape[1]
    terms = _bf16_terms(msgs[:, :dim].to(torch.float32)
                        * _head_replicate(w_t, dim))
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, ranks, terms)


def _wseg_t_bwd_plain(msgs, w_t, g16, ranks):
    e, dim = msgs.shape
    g_e = g16.index_select(0, ranks).to(torch.float32)
    dmsg = (g_e * _head_replicate(w_t, dim)).to(torch.bfloat16)
    dw = (msgs.to(torch.float32) * g_e).reshape(e, w_t.shape[0], -1).sum(-1)
    return dmsg, dw.t().contiguous()


def _call(kernel: str, tensors, ints):
    """Launch csrc/<kernel>.cu on PyTorch's current stream: its entry point
    takes the tensors' pointers, then `ints`, then the stream. Tensors must
    be contiguous and on one device; the types and shapes are the
    wrapper's to check."""
    dev = tensors[-1].device
    for x in tensors:
        if x.device != dev or not x.is_contiguous():
            raise ValueError("%s: inputs must be contiguous tensors on %s"
                             % (kernel, dev))
    fn = getattr(cuda_build.load(kernel), kernel + "_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in tensors), *ints, stream)
    if rc != 0:
        raise RuntimeError("%s: kernel launch failed with CUDA error %d"
                           % (kernel, rc))
    LAUNCHES[kernel] += 1


def _check_ranks(kernel: str, ranks):
    if ranks.dtype != torch.int32:
        raise TypeError("%s: ranks must be int32, got %s" % (kernel,
                                                             ranks.dtype))


def _launch(kernel: str, inputs, out, num_edges: int, dim: int, act: str):
    """Launch a FiLM kernel into the zeroed `out`. Inputs must be
    contiguous bf16 tensors plus int32 ranks (last), on out's device; the
    ranks must be nondecreasing, gap-free and below the table height (the
    contract of pad_graph_batch, not checked here)."""
    if num_edges == 0:
        return out
    *streams, ranks = inputs
    for x in streams:
        if x.dtype != torch.bfloat16:
            raise TypeError("%s: expected bfloat16, got %s" % (kernel,
                                                               x.dtype))
    _check_ranks(kernel, ranks)
    _call(kernel, (*inputs, out), (num_edges, dim, ACT_IDS[act]))
    return out


# Stream types K5a takes, by the id of its `in_type` argument.
SEGSUM_TYPES = {torch.float32: 0, torch.bfloat16: 1}


# `block_edges` and `win` keep the JAX `_impl` signatures: the CUDA kernels
# walk sorted ranks directly and need neither a step block nor a window.

def _segsum_table_impl(msgs, rcv_rank, *, table_rows, block_edges=256,
                       win=0):
    """K5a: table[r] = sum_{rank_e = r} bf16(m_e) for an f32 or bf16
    stream m [E, D] and nondecreasing gap-free int32 ranks [E]; f32
    [table_rows, D] out. The kernel rounds each term as it loads it, so an
    f32 stream needs no separate cast pass."""
    e, dim = msgs.shape
    if rcv_rank.shape != (e,):
        raise ValueError("segsum: shapes %s, %s" % (tuple(msgs.shape),
                                                    tuple(rcv_rank.shape)))
    if msgs.device.type == "cpu":
        return _segsum_plain(msgs, rcv_rank, table_rows)
    if msgs.dtype not in SEGSUM_TYPES:
        raise TypeError("segsum: expected float32 or bfloat16, got %s"
                        % msgs.dtype)
    _check_ranks("segsum", rcv_rank)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=msgs.device)
    if e:
        _call("segsum", (msgs, rcv_rank, out),
              (e, dim, SEGSUM_TYPES[msgs.dtype]))
    return out


def _expand_impl(table, rcv_rank, *, block_edges=256, win=0):
    """K5b: out[e] = bf16(table[rank_e]) widened to f32, [E, D], from an
    f32 table [rows, D] and int32 ranks below `rows`."""
    e = rcv_rank.shape[0]
    dim = table.shape[1]
    if rcv_rank.dim() != 1 or table.dim() != 2:
        raise ValueError("expand: shapes %s, %s" % (tuple(table.shape),
                                                    tuple(rcv_rank.shape)))
    if table.device.type == "cpu":
        return _expand_plain(table, rcv_rank)
    if table.dtype != torch.float32:
        raise TypeError("expand: expected float32, got %s" % table.dtype)
    _check_ranks("expand", rcv_rank)
    out = torch.empty((e, dim), dtype=torch.float32, device=table.device)
    if e:
        _call("expand", (table, rcv_rank, out), (e, dim))
    return out


def _film_fwd_impl(msgs, gb_table, ranks, *, block_edges=256, act, win=0):
    """K1: table[r] = sum_{rank_e = r} bf16(act(gamma[r] * m_e + beta[r]))
    for bf16 m [E, D] and gamma|beta [RPAD, 2D]; f32 [RPAD, D] out."""
    e, dim = msgs.shape
    rpad = gb_table.shape[0]
    if gb_table.shape != (rpad, 2 * dim) or ranks.shape != (e,):
        raise ValueError("film_fwd: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(gb_table.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return _film_fwd_plain(msgs, gb_table, ranks, act)
    out = torch.zeros((rpad, dim), dtype=torch.float32, device=msgs.device)
    return _launch("film_fwd", (msgs, gb_table, ranks), out, e, dim, act)


def _film_bwd_dgb_impl(msgs, gbg_table, ranks, *, block_edges=256, act,
                       win=0):
    """K2: d_gamma | d_beta [RPAD, 2D] f32 of K1 from bf16 m [E, D] and
    gamma|beta|g [RPAD, 3D]."""
    e, dim = msgs.shape
    rpad = gbg_table.shape[0]
    if gbg_table.shape != (rpad, 3 * dim) or ranks.shape != (e,):
        raise ValueError("film_bwd_dgb: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(gbg_table.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return _film_bwd_dgb_plain(msgs, gbg_table, ranks, act)
    out = torch.zeros((rpad, 2 * dim), dtype=torch.float32,
                      device=msgs.device)
    return _launch("film_bwd_dgb", (msgs, gbg_table, ranks), out, e, dim, act)


def _film_src_bwd_impl(gcb_src, t_ranked, ranks, *, table_rows, block_edges=256,
                       act, win=0):
    """K3: dt[s] = sum_{src rank_e = s} bf16(act'(z_e) * C_e), z_e =
    gamma_e * t[s] + beta_e, from the bf16 [E, 3D] gamma|beta|C stream and
    the bf16 [table_rows, D] t table; f32 [table_rows, D] out."""
    e = ranks.shape[0]
    dim = t_ranked.shape[1]
    if gcb_src.shape != (e, 3 * dim) or t_ranked.shape[0] != table_rows:
        raise ValueError("film_src_bwd: shapes %s, %s, %s" % (
            tuple(gcb_src.shape), tuple(t_ranked.shape), tuple(ranks.shape)))
    if gcb_src.device.type == "cpu":
        return _film_src_bwd_plain(gcb_src, t_ranked, ranks, table_rows, act)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=gcb_src.device)
    return _launch("film_src_bwd", (gcb_src, t_ranked, ranks), out, e, dim,
                   act)


# ---- the head-major attention kernels (K6, K7) ---------------------------

# Most heads the wrappers of K7a and K7b accept. It is a round number well
# above any config's 8, not either kernel's own limit: K7a stages K x 64
# f32 weights in at most 48 KB of shared memory (K <= 192), K7b gives each
# (edge, head) pair one of a block's 256 threads (K <= 256).
MAX_HEADS = 128


def _check_dtype(kernel: str, x, dtype):
    if x.dtype != dtype:
        raise TypeError("%s: expected %s, got %s" % (kernel, dtype, x.dtype))


def _check_heads(kernel: str, dim: int, num_heads: int):
    if not 0 < num_heads <= MAX_HEADS or dim % num_heads:
        raise ValueError("%s: %d columns do not split into %d heads (at "
                         "most %d)" % (kernel, dim, num_heads, MAX_HEADS))


def _segsum_t_impl(msgs_t, ranks, *, table_rows, block_edges=256, win=0):
    """K6a: table_t[k, r] = sum_{rank_e = r} bf16(m_t[k, e]) for an f32
    head-major stream m_t [K, E] and nondecreasing gap-free int32 ranks
    [E]; f32 [K, table_rows] out."""
    k, e = msgs_t.shape
    if ranks.shape != (e,):
        raise ValueError("segsum_t: shapes %s, %s" % (tuple(msgs_t.shape),
                                                      tuple(ranks.shape)))
    if msgs_t.device.type == "cpu":
        return _segsum_t_plain(msgs_t, ranks, table_rows)
    _check_dtype("segsum_t", msgs_t, torch.float32)
    _check_ranks("segsum_t", ranks)
    out = torch.zeros((k, table_rows), dtype=torch.float32,
                      device=msgs_t.device)
    if e and k:
        _call("segsum_t", (msgs_t, ranks, out), (e, table_rows, k))
    return out


def _expand_t_impl(table_t, ranks, *, block_edges=256, win=0):
    """K6b: out[k, e] = bf16(table_t[k, rank_e]) widened to f32, [K, E],
    from an f32 table [K, rows] and int32 ranks below `rows`."""
    if ranks.dim() != 1 or table_t.dim() != 2:
        raise ValueError("expand_t: shapes %s, %s" % (tuple(table_t.shape),
                                                      tuple(ranks.shape)))
    k, rows = table_t.shape
    e = ranks.shape[0]
    if table_t.device.type == "cpu":
        return _expand_t_plain(table_t, ranks)
    _check_dtype("expand_t", table_t, torch.float32)
    _check_ranks("expand_t", ranks)
    out = torch.empty((k, e), dtype=torch.float32, device=table_t.device)
    if e and k:
        _call("expand_t", (table_t, ranks, out), (e, rows, k))
    return out


def _wseg_t_impl(msgs, w_t, ranks, *, table_rows, num_heads, block_edges=256,
                 win=0, d_used=None):
    """K7a: table[r] = sum_{rank_e = r} bf16(m_e[:d] * rep(w_t[:, e])) for
    a bf16 stream m [E, D (+ extra)], f32 head-major weights w_t [K, E]
    (head k weighs columns k * D/K ... (k+1) * D/K) and int32 ranks; f32
    [table_rows, D] out. `msgs` may carry extra trailing columns: with
    `d_used` only the first d are aggregated, without a slicing copy."""
    e, dim_in = msgs.shape
    dim = d_used or dim_in
    if (w_t.shape != (num_heads, e) or ranks.shape != (e,)
            or dim > dim_in):
        raise ValueError("wseg_t: shapes %s, %s, %s, d_used %s" % (
            tuple(msgs.shape), tuple(w_t.shape), tuple(ranks.shape), d_used))
    _check_heads("wseg_t", dim, num_heads)
    if msgs.device.type == "cpu":
        return _wseg_t_plain(msgs, w_t, ranks, table_rows, d_used)
    _check_dtype("wseg_t", msgs, torch.bfloat16)
    _check_dtype("wseg_t", w_t, torch.float32)
    _check_ranks("wseg_t", ranks)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=msgs.device)
    if e:
        _call("wseg_t", (msgs, w_t, ranks, out), (e, dim, dim_in, num_heads))
    return out


def _wseg_t_bwd_impl(msgs, w_t, g16, ranks, *, num_heads, block_edges=256,
                     win=0):
    """K7b: with g_e = g16[rank_e], d_msgs[e] = bf16(g_e * rep(w_t[:, e]))
    [E, D] bf16 and d_w_t[k, e] = sum over head k's columns of m_e * g_e
    [K, E] f32, from the bf16 stream m [E, D], the f32 weights w_t [K, E]
    and the bf16 table cotangent g16 [rows, D]."""
    e, dim = msgs.shape
    if (w_t.shape != (num_heads, e) or ranks.shape != (e,)
            or g16.dim() != 2 or g16.shape[1] != dim):
        raise ValueError("wseg_t_bwd: shapes %s, %s, %s, %s" % (
            tuple(msgs.shape), tuple(w_t.shape), tuple(g16.shape),
            tuple(ranks.shape)))
    _check_heads("wseg_t_bwd", dim, num_heads)
    if msgs.device.type == "cpu":
        return _wseg_t_bwd_plain(msgs, w_t, g16, ranks)
    _check_dtype("wseg_t_bwd", msgs, torch.bfloat16)
    _check_dtype("wseg_t_bwd", g16, torch.bfloat16)
    _check_dtype("wseg_t_bwd", w_t, torch.float32)
    _check_ranks("wseg_t_bwd", ranks)
    dmsg = torch.empty((e, dim), dtype=torch.bfloat16, device=msgs.device)
    dw_t = torch.empty((num_heads, e), dtype=torch.float32,
                       device=msgs.device)
    if e:
        _call("wseg_t_bwd", (msgs, w_t, g16, ranks, dmsg, dw_t),
              (e, dim, num_heads))
    return dmsg, dw_t


# ---- public segment-sum / expand, each the other's VJP ------------------

class _RankedSegmentSum(torch.autograd.Function):
    """K5a forward; its VJP is K5b of the table cotangent, cast to the
    message dtype (the JAX package's _segsum_fwd / _segsum_bwd)."""

    @staticmethod
    def forward(ctx, msgs, ranks, table_rows):
        ctx.save_for_backward(ranks)
        ctx.msgs_dtype = msgs.dtype
        return _segsum_table_impl(msgs, ranks, table_rows=table_rows)

    @staticmethod
    def backward(ctx, g):
        (ranks,) = ctx.saved_tensors
        d_msgs = _expand_impl(g.contiguous(), ranks)
        return d_msgs.to(ctx.msgs_dtype), None, None


class _RankedExpand(torch.autograd.Function):
    """K5b forward; its VJP is K5a of the per-edge cotangent, cast to the
    table dtype (the JAX package's _expand_fwd / _expand_bwd)."""

    @staticmethod
    def forward(ctx, table, ranks, table_rows):
        ctx.save_for_backward(ranks)
        ctx.table_dtype, ctx.table_rows = table.dtype, table_rows
        return _expand_impl(table, ranks)

    @staticmethod
    def backward(ctx, g):
        (ranks,) = ctx.saved_tensors
        d_table = _segsum_table_impl(g.contiguous(), ranks,
                                     table_rows=ctx.table_rows)
        return d_table.to(ctx.table_dtype), None, None


def ranked_segment_sum_table(msgs, ranks, table_rows: int):
    """Sum messages per rank: [E, D] -> [table_rows, D] f32. `ranks` are
    nondecreasing gap-free group ids of the stream; VJP: d_msgs[e] =
    bf16(d_table[rank_e])."""
    return _RankedSegmentSum.apply(msgs, ranks, table_rows)


def ranked_expand_table(table, ranks, table_rows: int):
    """Per-edge value of a rank-indexed table, out[e] = bf16(table[rank_e])
    as f32: the inverse of ranked_segment_sum_table and its VJP."""
    return _RankedExpand.apply(table, ranks, table_rows)


class _RankedSegmentSumT(torch.autograd.Function):
    """K6a forward; its VJP is K6b of the table cotangent, cast to the
    stream dtype (the JAX package's _segsum_t_fwd / _segsum_t_bwd)."""

    @staticmethod
    def forward(ctx, msgs_t, ranks, table_rows):
        ctx.save_for_backward(ranks)
        ctx.msgs_dtype = msgs_t.dtype
        return _segsum_t_impl(msgs_t, ranks, table_rows=table_rows)

    @staticmethod
    def backward(ctx, g):
        (ranks,) = ctx.saved_tensors
        d_msgs = _expand_t_impl(g.contiguous(), ranks)
        return d_msgs.to(ctx.msgs_dtype), None, None


class _RankedExpandT(torch.autograd.Function):
    """K6b forward; its VJP is K6a of the per-edge cotangent, cast to the
    table dtype (the JAX package's _expand_t_fwd / _expand_t_bwd)."""

    @staticmethod
    def forward(ctx, table_t, ranks, table_rows):
        ctx.save_for_backward(ranks)
        ctx.table_dtype, ctx.table_rows = table_t.dtype, table_rows
        return _expand_t_impl(table_t, ranks)

    @staticmethod
    def backward(ctx, g):
        (ranks,) = ctx.saved_tensors
        d_table = _segsum_t_impl(g.contiguous(), ranks,
                                 table_rows=ctx.table_rows)
        return d_table.to(ctx.table_dtype), None, None


def ranked_segment_sum_table_t(msgs_t, ranks, table_rows: int):
    """Head-major ranked segment-sum: [K, E] -> [K, table_rows] f32; VJP:
    d_msgs_t[:, e] = bf16(d_table_t[:, rank_e])."""
    return _RankedSegmentSumT.apply(msgs_t, ranks, table_rows)


def ranked_expand_table_t(table_t, ranks, table_rows: int):
    """Head-major ranked expand: out[:, e] = bf16(table_t[:, rank_e]) as
    f32, the inverse of ranked_segment_sum_table_t and its VJP.
    `table_rows` is table_t's width."""
    return _RankedExpandT.apply(table_t, ranks, table_rows)


class _RankedWeightedSegmentSumT(torch.autograd.Function):
    """K7a forward; K7b backward on the table cotangent rounded to bf16,
    each half cast back to its primal's dtype (the JAX package's
    _wseg_t_vjp_fwd / _wseg_t_vjp_bwd)."""

    @staticmethod
    def forward(ctx, msgs, w_t, ranks, table_rows, num_heads):
        ctx.save_for_backward(msgs, w_t, ranks)
        ctx.num_heads = num_heads
        return _wseg_t_impl(msgs, w_t, ranks, table_rows=table_rows,
                            num_heads=num_heads)

    @staticmethod
    def backward(ctx, g):
        msgs, w_t, ranks = ctx.saved_tensors
        d_msgs, d_wt = _wseg_t_bwd_impl(
            msgs, w_t, g.to(torch.bfloat16).contiguous(), ranks,
            num_heads=ctx.num_heads)
        return d_msgs.to(msgs.dtype), d_wt.to(w_t.dtype), None, None, None


def ranked_weighted_segment_sum_t(msgs, w_t, ranks, table_rows: int,
                                  num_heads: int):
    """Per-head weighted segment-sum with head-major weights: table[r] =
    sum_{rank_e = r} m_e * rep(w_t[:, e]), [E, D] x [K, E] ->
    [table_rows, D] f32. VJP: d_msgs (in msgs' dtype) and d_w_t."""
    return _RankedWeightedSegmentSumT.apply(msgs, w_t, ranks, table_rows,
                                            num_heads)


# ---- the gather-fused FiLM pass ---------------------------------------

def _clip(idx, rows: int):
    """jnp.take(..., mode="clip") index semantics: padded edges carry
    src_flat = L * n_pad, one row past the table."""
    return idx.clamp(0, rows - 1)


class _FilmFusedSrcPass(torch.autograd.Function):
    """FiLM message pass with the source-side gather fused into the
    backward (the JAX package's film_fused_src_pass, _ffsp_fwd/_ffsp_bwd).

    Forward: m = t_flat[src_idx] (bf16), then K1 over fine ranks.
    Backward: K2 gives d_gamma|d_beta in receiver order; dt is recomputed
    in SOURCE order by K3 from the small tables (gamma|beta|C = gamma * g
    gathered per edge by fine rank, t rows gathered by src rank), so no
    [E, D] cotangent is permuted between edge orders. Returns d_t in
    t_flat's dtype (bf16 on the fused path) and dgb in gb_table's (f32).
    """

    @staticmethod
    def forward(ctx, t_flat, gb_table, src_idx, fine_rank_by_src,
                src_sorted_rank, src_to_rank, src_from_rank, ranks, act):
        gb16 = gb_table.to(torch.bfloat16)
        t16 = t_flat.to(torch.bfloat16)
        m = t16.index_select(0, _clip(src_idx, t16.shape[0]))
        table = _film_fwd_impl(m, gb16, ranks, act=act)
        ctx.save_for_backward(m, gb16, t16, fine_rank_by_src,
                              src_sorted_rank, src_to_rank, src_from_rank,
                              ranks)
        ctx.act = act
        ctx.t_dtype, ctx.gb_dtype = t_flat.dtype, gb_table.dtype
        return table

    @staticmethod
    def backward(ctx, g):
        (m, gb16, t16, fine_rank_by_src, src_sorted_rank, src_to_rank,
         src_from_rank, ranks) = ctx.saved_tensors
        d = m.shape[1]
        g16 = g.to(torch.bfloat16)
        dgb = _film_bwd_dgb_impl(m, torch.cat([gb16, g16], dim=1), ranks,
                                 act=ctx.act)
        # The port's src stream is undiluted, so every fine key is a real
        # table row (the JAX package appends a zero row for its diluted
        # stream's fill slots).
        gcb_table = torch.cat([gb16, gb16[:, :d] * g16], dim=1)
        gcb_src = gcb_table.index_select(0, fine_rank_by_src)
        t_ranked = t16.index_select(0, _clip(src_from_rank, t16.shape[0]))
        dt_table = _film_src_bwd_impl(
            gcb_src, t_ranked, src_sorted_rank,
            table_rows=src_from_rank.shape[0], act=ctx.act)
        # Source groups with no real edge (src_to_rank -1) get zero.
        valid = (src_to_rank >= 0)[:, None]
        d_t = dt_table.index_select(0, src_to_rank.clamp(min=0))
        d_t = torch.where(valid, d_t, 0.0).to(ctx.t_dtype)
        return (d_t, dgb.to(ctx.gb_dtype), None, None, None, None, None,
                None, None)


def film_fused_src_pass(t_flat, gb_table, src_idx, fine_rank_by_src,
                        src_sorted_rank, src_to_rank, src_from_rank, ranks,
                        act: str):
    """FiLM modulate-activate-aggregate into the fine rank table
    [RPAD, D] f32; see _FilmFusedSrcPass."""
    return _FilmFusedSrcPass.apply(t_flat, gb_table, src_idx,
                                   fine_rank_by_src, src_sorted_rank,
                                   src_to_rank, src_from_rank, ranks,
                                   act.lower())
