"""Fused GNN-FiLM rank-table kernels (counterpart of the FiLM part of
tf_gnn_samples_tpu/ops/ranked_segment.py).

The flat edge stream (ops/graph.py FlatEdges) is receiver-sorted with
gap-free fine (receiver, type) ranks; its src-sorted view has gap-free
src ranks. Three CUDA kernels (csrc/) reduce over those sorted ranks:

* K1 `_film_fwd_impl`: table[r] = sum bf16(act(gamma[r] * m_e + beta[r]));
* K2 `_film_bwd_dgb_impl`: d_gamma | d_beta of K1 in receiver order;
* K3 `_film_src_bwd_impl`: dt over the src-sorted stream, recomputing z.

Each wrapper launches its kernel for CUDA tensors and raises on anything
the kernel does not take; it runs the plain PyTorch version beside it only
for tensors on the CPU. `LAUNCHES` counts kernel launches, one per wrapper
call that reached its kernel.

Numerics follow the TPU kernels' rounding points: z is computed in f32
from bf16 operands, and every summed term (the activation in K1, m * dz
and dz in K2, act'(z) * C in K3) is rounded to bf16 before its f32 sum.
The kernels sum in stream order with atomics at chunk seams, so their sums
differ from run to run in the last bits; the terms do not.
"""

import math
from typing import Dict

import torch

from . import cuda_build


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


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

LAUNCHES: Dict[str, int] = {"film_fwd": 0, "film_bwd_dgb": 0,
                            "film_src_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bf16_terms(x):
    """Round per-edge terms to bf16, then widen for the f32 sum."""
    return x.to(torch.bfloat16).to(torch.float32)


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


def _launch(kernel: str, inputs, out, num_edges: int, dim: int, act: str):
    """Launch csrc/<kernel>.cu on PyTorch's current stream into the zeroed
    `out`. Inputs must be contiguous bf16 tensors plus int32 ranks (last),
    on out's device; the ranks must be nondecreasing, gap-free and below
    the table height (the batch builder's contract, not checked here)."""
    if num_edges == 0:
        return out
    dev = out.device
    *streams, ranks = inputs
    for x in streams:
        if x.dtype != torch.bfloat16:
            raise TypeError("%s: expected bfloat16, got %s" % (kernel,
                                                               x.dtype))
    if ranks.dtype != torch.int32:
        raise TypeError("%s: ranks must be int32, got %s" % (kernel,
                                                             ranks.dtype))
    for x in inputs:
        if x.device != dev or not x.is_contiguous():
            raise ValueError("%s: inputs must be contiguous tensors on %s"
                             % (kernel, dev))
    fn = getattr(cuda_build.load(kernel), kernel + "_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in inputs), out.data_ptr(), num_edges,
                dim, ACT_IDS[act], stream)
    if rc != 0:
        raise RuntimeError("%s: kernel launch failed with CUDA error %d"
                           % (kernel, rc))
    LAUNCHES[kernel] += 1
    return out


# `block_edges` and `win` keep the JAX `_impl` signatures: the CUDA kernels
# walk sorted ranks directly and need neither a step block nor a window.

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
