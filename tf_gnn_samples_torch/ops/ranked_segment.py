"""Rank-table kernels (counterpart of tf_gnn_samples_tpu/ops/ranked_segment.py:
the ranked segment-sum / expand pair, the fused GNN-FiLM kernels, the
head-major attention kernels of RGAT, the expand-add-activate /
activate-aggregate pairs of GNN-Edge-MLP1, its typed dense aggregate and
its source-order recompute, the row-major weighted segment-sum and the
packed sign-mask variants of the FiLM kernels).

The flat edge stream (ops/graph.py FlatEdges) is receiver-sorted with
gap-free coarse (receiver) and fine (receiver, type) ranks; its src-sorted
view has gap-free src ranks. Twenty-three CUDA kernels (csrc/) work over
those sorted ranks:

* K5a `_segsum_table_impl`: table[r] = sum bf16(m_e) (the ranked
  segment-sum of RGCN/GGNN aggregation, and the VJP of K5b);
* K5b `_expand_impl`: out[e] = bf16(table[rank_e]) (the VJP of K5a);
* K1 `_film_fwd_impl`: table[r] = sum bf16(act(gamma[r] * m_e + beta[r]));
* K2 `_film_bwd_dgb_impl`: d_gamma | d_beta of K1 in receiver order
  (`_film_bwd_dgb_split_impl`: the same from gamma|beta and g apart);
* K3 `_film_src_bwd_impl`: dt over the src-sorted stream, recomputing z
  (`_film_src_bwd_gather_impl`: the same reading gamma|beta, g and t
  through the edges' fine ranks and the src groups' rows, as the fused
  FiLM backward calls it);
* K6a `_segsum_t_impl`: table_t[k, r] = sum bf16(m_t[k, e]), head-major
  [K, E] -> [K, R] (the RGAT softmax denominator, and the VJP of K6b);
* K6b `_expand_t_impl`: out[k, e] = bf16(table_t[k, rank_e]) (the VJP of
  K6a);
* K7a `_wseg_t_impl`: table[r] = sum bf16(m_e * rep(w_t[:, e])), the
  attention-weighted aggregation with head-major [K, E] weights;
* K7b `_wseg_t_bwd_impl`: d_msgs and d_w_t of K7a;
* K4 `_film_bwd_impl`: d_msgs and d_gamma | d_beta of K1 in receiver order
  (the VJP of `film_ranked_aggregate`, GNN-FiLM's normalised branch;
  `_film_bwd_split_impl`: the same from gamma|beta and g apart);
* K8 `_wseg_t_dw_impl`: the d_w_t half of K7b alone;
* K9 `_rgat_src_bwd_impl`: RGAT's message and source-logit cotangents over
  the src-sorted stream, recomputing the attention
  (`_rgat_src_bwd_gather_impl`: the same reading each edge's row of the
  side table through its fine key; with K8, the backward of
  `rgat_fused_pass`);
* K11a `_expand_add_act_impl`: x[e] = bf16(act(m_e + bf16(beta[rank_e])))
  (the hidden assembly of GNN-Edge-MLP1 over the type-major ranks);
* K11b `_expand_add_act_bwd_impl`: dz = bf16(act'(x) * dx) with act' taken
  from the OUTPUT x, written per edge and summed per rank (d_beta);
* K12a `_act_agg_slices_impl`: table[r] = sum bf16(act(msg_e)) over
  several stream slices with disjoint rank rows (K1 without the
  modulation tables; one launch for all of a layer's edge type slices;
  `_act_agg_impl`: one slice);
* K12b `_act_agg_bwd_impl`: d_msg[e] = bf16(act'(msg_e) * g[rank_e]);
* K10a `_typed_dense_agg_impl`: table[r] = sum bf16(act(x_e @ W[type_e]))
  (GNN-Edge-MLP1's `fused1` branch);
* K10b `_typed_dense_agg_bwd_impl`: its dx (bf16) and dW (f32);
* K14 `_emlp1_src_bwd_impl`: GNN-Edge-MLP1's message cotangent over the
  src-sorted stream, recomputing the hidden layer and both W1 products
  (the backward of `emlp1_tm_pass`);
* K13a `_wseg_impl` / K13b `_wseg_bwd_impl`: K7a / K7b with row-major
  [E, K] weights (`ranked_weighted_segment_sum`);
* K15a `_film_fwd_mask_impl`: K1 that also writes each edge's packed sign
  mask (z > 0), 16 bits to an f32 lane;
* K15b `_masked_segsum_impl`: dt[r] = sum bf16(C_e * factor(mask_e)), the
  relu / leaky_relu derivative taken from that mask.

K13 and K15 are the JAX package's ops of the same names, which no model
path of either package calls.

Each wrapper launches its kernel for CUDA tensors and raises on anything
the kernel does not take; it runs the plain PyTorch version beside it only
for tensors on the CPU. `LAUNCHES` counts kernel launches, one per wrapper
call that reached its kernel; it also counts those of the K16 variants of
the harnesses in tf_gnn_samples_torch/tools/, one counter per kernel body,
and those of the earlier designs of K3, K4, K9, K12a, K7a, K6a, K10a,
K10b, K14 and K15a (tools/earlier_designs.py). `FORM_LAUNCHES` counts K9's launches by form.

Numerics follow the TPU kernels' rounding points: z is computed in f32
from bf16 operands, and every summed term (the message in K5a, the
activation in K1, m * dz and dz in K2, act'(z) * C in K3, the head-major
term in K6a, the weighted message in K7a, both halves of K9's row, dz in
K11b, the activation in K12a, K10a and K15a, the message cotangent in K14,
the weighted message in K13a, the masked product in K15b) is
rounded to bf16 before its f32 sum; K5b and K6b round each table value to
bf16; K7b, K13b, K4 and K10b write d_msgs / dx in bf16; K7b and K8 keep
d_w_t, K13b d_w, K10b dW in f32. The typed products of K10 and K14 sum
their f32 products in another order than the plain versions' matmuls
(on the tensor cores, whose f32 accumulation truncates).
The kernels sum in stream order with atomics at chunk seams, so their
sums differ from run to run in the last bits; the terms do not.
"""

import ctypes
import math
from typing import Dict

import torch

from .. import SMALL_NUMBER
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


# Activations whose derivative is a function of their OUTPUT x = act(z):
# elu' = 1 (x > 0) else x + 1; relu' = (x > 0); leaky_relu' = 1 (x > 0)
# else 0.2 (its sign survives); linear' = 1. K11b reads these, so the
# expand-add-activate pass keeps no activation residual beside its output.
_ACTS_FROM_OUT = {
    "elu": lambda x: torch.where(x > 0, 1.0, x + 1.0),
    "relu": lambda x: (x > 0).to(torch.float32),
    "leaky_relu": lambda x: torch.where(x > 0, 1.0, 0.2),
    "linear": lambda x: torch.ones_like(x),
}


def expand_add_act_supported(act: str) -> bool:
    return act.lower() in _ACTS_FROM_OUT and act.lower() in _ACTS


# ---- kernels and their plain versions ---------------------------------

LAUNCHES: Dict[str, int] = {"segsum": 0, "expand": 0, "film_fwd": 0,
                            "film_bwd_dgb": 0, "film_src_bwd": 0,
                            "segsum_t": 0, "expand_t": 0, "wseg_t": 0,
                            "wseg_t_bwd": 0, "film_bwd": 0, "wseg_t_dw": 0,
                            "rgat_src_bwd": 0, "expand_add_act": 0,
                            "expand_add_act_bwd": 0, "act_agg": 0,
                            "act_agg_bwd": 0, "typed_dense_agg": 0,
                            "typed_dense_agg_bwd": 0, "emlp1_src_bwd": 0,
                            "wseg": 0, "wseg_bwd": 0, "film_fwd_mask": 0,
                            "masked_segsum": 0,
                            # K16, the A/B variants of the tools/ harnesses
                            # (tf_gnn_samples_torch/tools/), by kernel body
                            "film_fwd_v3": 0, "film_fwd_v2a": 0,
                            "film_fwd_v2b": 0, "film_dgb_v3": 0,
                            "film_dgb_v4": 0, "rowgather_loop": 0,
                            "rowgather_loop8": 0, "rowgather_take": 0,
                            "rowgather_onehot": 0,
                            # the earlier designs of K3, K4, K12a, K9, K7a,
                            # K6a, K10a, K10b, K14, K15a and K15b
                            # (tools/earlier_designs.py)
                            "film_src_bwd_walk": 0, "film_bwd_walk": 0,
                            "act_agg_walk": 0, "rgat_src_bwd_walk": 0,
                            "wseg_t_walk": 0, "segsum_t_walk": 0,
                            "typed_dense_agg_scalar": 0,
                            "typed_dense_agg_bwd_scalar": 0,
                            "emlp1_src_bwd_scalar": 0,
                            "film_fwd_mask_walk": 0,
                            "masked_segsum_walk": 0}
# K9's launches (counted in LAUNCHES["rgat_src_bwd"]) by the form the
# wrapper launched.
FORM_LAUNCHES: Dict[str, int] = {"rgat_src_bwd gather": 0,
                                 "rgat_src_bwd stream": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for k in counts:
            counts[k] = 0


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


def _film_bwd_plain(msgs, gbg_table, ranks, act):
    d = msgs.shape[1]
    v = gbg_table.index_select(0, ranks).to(torch.float32)
    m = msgs.to(torch.float32)
    gamma = v[:, :d]
    dz = _ACTS[act][1](gamma * m + v[:, d:2 * d]) * v[:, 2 * d:]
    terms = torch.cat([_bf16_terms(m * dz), _bf16_terms(dz)], dim=1)
    d_gb = torch.zeros((gbg_table.shape[0], 2 * d), dtype=torch.float32,
                       device=msgs.device)
    return (gamma * dz).to(torch.bfloat16), d_gb.index_add_(0, ranks, terms)


def _film_src_bwd_plain(gcb_src, t_ranked, ranks, table_rows, act):
    d = t_ranked.shape[1]
    m = t_ranked.index_select(0, ranks).to(torch.float32)
    gcb = gcb_src.to(torch.float32)
    z = gcb[:, :d] * m + gcb[:, d:2 * d]
    out = torch.zeros((table_rows, d), dtype=torch.float32,
                      device=gcb_src.device)
    return out.index_add_(0, ranks,
                          _bf16_terms(_ACTS[act][1](z) * gcb[:, 2 * d:]))


def _src_stream_inputs(gb16, g16, fine_rank_by_src, t16, src_from_rank):
    """K3's stream-form inputs as the fused FiLM backward built them before
    the kernel read its rows itself (the JAX package's _ffsp_bwd still
    does): the bf16 [E, 3D] gamma|beta|C stream, C = bf16(gamma * g),
    gathered per edge at min(fine rank, RPAD) from the table with 8 zero
    rows appended (the diluted stream's SD_FILL keys read a zero row), and
    the bf16 t rows of the src groups, src_from_rank clipped to t16."""
    d = g16.shape[1]
    gcb_table = torch.cat([gb16, gb16[:, :d] * g16], dim=1)
    gcb_src = _zero_extended(gcb_table).index_select(
        0, fine_rank_by_src.clamp(max=gcb_table.shape[0]))
    return gcb_src, t16.index_select(0, _clip(src_from_rank, t16.shape[0]))


def _film_src_bwd_gather_plain(gb16, g16, fine_rank_by_src, t16,
                               src_from_rank, ranks, table_rows, act):
    """K3's gather form: its stream form on _src_stream_inputs."""
    return _film_src_bwd_plain(
        *_src_stream_inputs(gb16, g16, fine_rank_by_src, t16, src_from_rank),
        ranks, table_rows, act)


def _expand_add_act_plain(m, beta_table, ranks, act):
    beta_e = _bf16_terms(beta_table).index_select(0, ranks)
    return _ACTS[act][0](m.to(torch.float32) + beta_e).to(torch.bfloat16)


def _expand_add_act_bwd_plain(x, dx, ranks, table_rows, act):
    dz = (_ACTS_FROM_OUT[act](x.to(torch.float32))
          * dx.to(torch.float32)).to(torch.bfloat16)
    dbeta = torch.zeros((table_rows, x.shape[1]), dtype=torch.float32,
                        device=x.device)
    return dz, dbeta.index_add_(0, ranks, dz.to(torch.float32))


def _act_agg_plain(msgs, ranks, table_rows, act, out=None):
    if out is None:
        out = torch.zeros((table_rows, msgs.shape[1]), dtype=torch.float32,
                          device=msgs.device)
    return out.index_add_(
        0, ranks, _bf16_terms(_ACTS[act][0](msgs.to(torch.float32))))


def _act_agg_slices_plain(slices, table_rows, act, out=None):
    for msgs, ranks in slices:
        out = _act_agg_plain(msgs, ranks, table_rows, act, out)
    return out


def _act_agg_bwd_plain(msgs, g16, ranks, act):
    g_e = g16.index_select(0, ranks).to(torch.float32)
    return (_ACTS[act][1](msgs.to(torch.float32)) * g_e).to(torch.bfloat16)


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


def _wseg_t_dw_plain(msgs, g16, ranks, num_heads, d_used=None):
    dim = d_used or msgs.shape[1]
    g_e = g16.index_select(0, ranks).to(torch.float32)
    dw = (msgs[:, :dim].to(torch.float32) * g_e).reshape(
        msgs.shape[0], num_heads, -1).sum(-1)
    return dw.t().contiguous()


def _wseg_plain(msgs, w, ranks, table_rows):
    dim = msgs.shape[1]
    terms = _bf16_terms(msgs.to(torch.float32) * _head_replicate(w.t(), dim))
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, ranks, terms)


def _wseg_bwd_plain(msgs, w, g16, ranks):
    e, dim = msgs.shape
    g_e = g16.index_select(0, ranks).to(torch.float32)
    dmsg = (g_e * _head_replicate(w.t(), dim)).to(torch.bfloat16)
    dw = (msgs.to(torch.float32) * g_e).reshape(e, w.shape[1], -1).sum(-1)
    return dmsg, dw


def _rgat_src_bwd_plain(gcb_src, t_ext, ranks, table_rows, num_heads, clamp):
    e, k = ranks.shape[0], num_heads
    d = t_ext.shape[1] - k
    mt = t_ext.index_select(0, ranks).to(torch.float32)
    m, lsrc = mt[:, :d], mt[:, d:]
    gcb = gcb_src.to(torch.float32)
    dagg, lt = gcb[:, :d], gcb[:, d:d + k]
    den, s_cor = gcb[:, d + k:d + 2 * k], gcb[:, d + 2 * k:]
    pre = lsrc + lt
    logit = torch.where(pre > 0, pre, 0.2 * pre)
    attn = torch.exp(logit.clamp(-clamp, clamp)) / (den + SMALL_NUMBER)
    draw = (m * dagg).reshape(e, k, -1).sum(-1)
    # The forward clamps the logit before exp: no gradient where it did.
    dlog = attn * (draw - s_cor) * (logit.abs() < clamp).to(torch.float32)
    dpre = torch.where(pre > 0, dlog, 0.2 * dlog)
    dmsg = attn.repeat_interleave(d // k, dim=1) * dagg
    out = torch.zeros((table_rows, d + k), dtype=torch.float32,
                      device=gcb_src.device)
    return out.index_add_(
        0, ranks, torch.cat([_bf16_terms(dmsg), _bf16_terms(dpre)], dim=1))


def _side_rows(side, fine_key):
    """K9's gather-form rows as its stream form reads them: row f_e of the
    side table, a zero row for a key outside [0, RPAD)."""
    rpad = side.shape[0]
    inside = (fine_key >= 0) & (fine_key < rpad)
    return _zero_extended(side).index_select(
        0, torch.where(inside, fine_key, rpad))


def _rgat_src_bwd_gather_plain(side, fine_key, t_ext, ranks, table_rows,
                               num_heads, clamp):
    """K9's gather form: its stream form on _side_rows."""
    return _rgat_src_bwd_plain(_side_rows(side, fine_key), t_ext, ranks,
                               table_rows, num_heads, clamp)


def _call(kernel: str, tensors, ints, counter: str = None, row_views=()):
    """Launch csrc/<kernel>.cu on PyTorch's current stream: its entry point
    takes the tensors' pointers (None: a null pointer, for an input that
    the kernel's form does not read), then `ints`, then the stream. Tensors
    must be on one device and contiguous, but those at the indices
    `row_views`: 2-D with unit column stride, whose row strides the
    wrapper passes in `ints`. The types and shapes are the wrapper's to
    check. The launch counts under `counter` (default: the kernel's name)
    where one source holds several kernel bodies."""
    dev = tensors[-1].device
    _check_laid_out(kernel, tensors, dev, row_views)
    _run(kernel, dev, (*(None if x is None else x.data_ptr()
                         for x in tensors), *ints), counter)


def _check_laid_out(kernel: str, tensors, dev, row_views=()):
    for i, x in enumerate(tensors):
        if x is None:
            continue
        laid_out = (x.dim() == 2 and x.stride(1) == 1 if i in row_views
                    else x.is_contiguous())
        if x.device != dev or not laid_out:
            raise ValueError("%s: inputs must be contiguous tensors (row "
                             "views: unit column stride) on %s"
                             % (kernel, dev))


def _run(kernel: str, dev, args, counter: str = None):
    """Call csrc/<kernel>.cu's entry point with `args` and the stream, and
    count the launch."""
    fn = getattr(cuda_build.load(kernel), cuda_build.entry(kernel))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError("%s: kernel launch failed with CUDA error %d"
                           % (kernel, rc))
    LAUNCHES[counter or kernel] += 1


# Edges a chunk of the sorted-rank walks (csrc/film_common.cuh CHUNK).
_ROW_CHUNK = 64


def _check_ranks(kernel: str, ranks):
    if ranks.dtype != torch.int32:
        raise TypeError("%s: ranks must be int32, got %s" % (kernel,
                                                             ranks.dtype))


def _check_dtype(kernel: str, x, dtype):
    if x.dtype != dtype:
        raise TypeError("%s: expected %s, got %s" % (kernel, dtype, x.dtype))


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
    gamma|beta|g [RPAD, 3D] (passed to the kernel as two views)."""
    e, dim = msgs.shape
    rpad = gbg_table.shape[0]
    if gbg_table.shape != (rpad, 3 * dim) or ranks.shape != (e,):
        raise ValueError("film_bwd_dgb: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(gbg_table.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return _film_bwd_dgb_plain(msgs, gbg_table, ranks, act)
    return _film_bwd_dgb_split_impl(msgs, gbg_table[:, :2 * dim],
                                    gbg_table[:, 2 * dim:], ranks, act=act)


def _film_bwd_dgb_split_impl(msgs, gb_table, g_table, ranks, *, act):
    """K2 from two tables, bf16 gamma|beta [RPAD, 2D] and g [RPAD, D], each
    row-major with unit column stride (whole tensors or column views);
    f32 [RPAD, 2D] out. The fused FiLM backward passes its two tables as
    they are, so no [RPAD, 3D] table is built for the kernel."""
    e, dim = msgs.shape
    rpad = gb_table.shape[0]
    if (gb_table.shape != (rpad, 2 * dim) or g_table.shape != (rpad, dim)
            or ranks.shape != (e,)):
        raise ValueError("film_bwd_dgb: shapes %s, %s, %s, %s" % (
            tuple(msgs.shape), tuple(gb_table.shape), tuple(g_table.shape),
            tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return _film_bwd_dgb_plain(
            msgs, torch.cat([gb_table, g_table], dim=1), ranks, act)
    for x in (msgs, gb_table, g_table):
        _check_dtype("film_bwd_dgb", x, torch.bfloat16)
    _check_ranks("film_bwd_dgb", ranks)
    out = torch.zeros((rpad, 2 * dim), dtype=torch.float32,
                      device=msgs.device)
    if e:
        _call("film_bwd_dgb", (msgs, gb_table, g_table, ranks, out),
              (e, dim, gb_table.stride(0), g_table.stride(0), ACT_IDS[act]),
              row_views=(1, 2))
    return out


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
    for x in (gcb_src, t_ranked):
        _check_dtype("film_src_bwd", x, torch.bfloat16)
    _check_ranks("film_src_bwd", ranks)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=gcb_src.device)
    if e:
        _call("film_src_bwd",
              (gcb_src, None, None, None, t_ranked, None, ranks, out),
              (e, dim, 0, 0, 0, table_rows, ACT_IDS[act]))
    return out


def _film_src_bwd_gather_impl(gb16, g16, fine_rank_by_src, t16,
                              src_from_rank, ranks, *, table_rows, act):
    """K3 reading its rows through indices: dt[s] = sum_{src rank_e = s}
    bf16(act'(z_e) * C_e) with gamma_e|beta_e = gb16[f_e], C_e =
    bf16(gamma_e * g16[f_e]), f_e = fine_rank_by_src[e] (a key outside
    [0, RPAD) adds zero: the diluted stream's SD_FILL slots), and z_e =
    gamma_e * t16[clip(src_from_rank[s])] + beta_e; f32 [table_rows, D]
    out. bf16 gamma|beta [RPAD, 2D] and g [RPAD, D] with unit column
    stride; bf16 t [T, D]; int32 fine ranks and src ranks [E] and
    src_from_rank [table_rows]. Equals _film_src_bwd_impl on
    _src_stream_inputs' stream and t rows, without building them."""
    e = ranks.shape[0]
    rpad, dim = g16.shape
    if (gb16.shape != (rpad, 2 * dim) or fine_rank_by_src.shape != (e,)
            or t16.dim() != 2 or t16.shape[1] != dim
            or src_from_rank.shape != (table_rows,)):
        raise ValueError("film_src_bwd (gather): shapes %s, %s, %s, %s, %s, "
                         "%s, table_rows %d" % (
                             tuple(gb16.shape), tuple(g16.shape),
                             tuple(fine_rank_by_src.shape), tuple(t16.shape),
                             tuple(src_from_rank.shape), tuple(ranks.shape),
                             table_rows))
    if g16.device.type == "cpu":
        return _film_src_bwd_gather_plain(gb16, g16, fine_rank_by_src, t16,
                                          src_from_rank, ranks, table_rows,
                                          act)
    for x in (gb16, g16, t16):
        _check_dtype("film_src_bwd", x, torch.bfloat16)
    for x in (fine_rank_by_src, src_from_rank, ranks):
        _check_ranks("film_src_bwd", x)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=g16.device)
    if e:
        _call("film_src_bwd",
              (None, gb16, g16, fine_rank_by_src, t16, src_from_rank, ranks,
               out),
              (e, dim, gb16.stride(0), g16.stride(0), rpad, t16.shape[0],
               ACT_IDS[act]), row_views=(1, 2))
    return out


def _film_bwd_impl(msgs, gbg_table, ranks, *, block_edges=256, act, win=0):
    """K4: (d_msgs, d_gamma | d_beta) of K1 from bf16 m [E, D] and
    gamma|beta|g [RPAD, 3D]: with z = gamma * m + beta and dz = act'(z) *
    g, d_msgs[e] = bf16(gamma * dz) [E, D] and d_gb[r] = sum_{rank_e = r}
    bf16(m * dz) | bf16(dz), f32 [RPAD, 2D]."""
    e, dim = msgs.shape
    rpad = gbg_table.shape[0]
    if gbg_table.shape != (rpad, 3 * dim) or ranks.shape != (e,):
        raise ValueError("film_bwd: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(gbg_table.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return _film_bwd_plain(msgs, gbg_table, ranks, act)
    return _film_bwd_split_impl(msgs, gbg_table[:, :2 * dim],
                                gbg_table[:, 2 * dim:], ranks, act=act)


def _film_bwd_split_impl(msgs, gb_table, g_table, ranks, *, act):
    """K4 from two tables, bf16 gamma|beta [RPAD, 2D] and g [RPAD, D], each
    row-major with unit column stride (whole tensors or column views);
    bf16 [E, D] d_msgs and f32 [RPAD, 2D] d_gb out. The FiLM aggregation's
    backward passes its two tables as they are, so no [RPAD, 3D] table is
    built for the kernel."""
    e, dim = msgs.shape
    rpad = gb_table.shape[0]
    if (gb_table.shape != (rpad, 2 * dim) or g_table.shape != (rpad, dim)
            or ranks.shape != (e,)):
        raise ValueError("film_bwd: shapes %s, %s, %s, %s" % (
            tuple(msgs.shape), tuple(gb_table.shape), tuple(g_table.shape),
            tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return _film_bwd_plain(msgs, torch.cat([gb_table, g_table], dim=1),
                               ranks, act)
    for x in (msgs, gb_table, g_table):
        _check_dtype("film_bwd", x, torch.bfloat16)
    _check_ranks("film_bwd", ranks)
    d_msgs = torch.empty((e, dim), dtype=torch.bfloat16, device=msgs.device)
    d_gb = torch.zeros((rpad, 2 * dim), dtype=torch.float32,
                       device=msgs.device)
    if e:
        _call("film_bwd", (msgs, gb_table, g_table, ranks, d_msgs, d_gb),
              (e, dim, gb_table.stride(0), g_table.stride(0), ACT_IDS[act]),
              row_views=(1, 2))
    return d_msgs, d_gb


# ---- the packed sign-mask variants of K1 and K3 (K15) ----------------------

# Activations whose derivative is a function of the sign mask alone:
# act'(z) = leak + (1 - leak) * (z > 0).
MASKABLE_ACTS = {"relu": 0.0, "leaky_relu": 0.2}

# Sign bits packed into one f32 lane as an exact small integer.
_MASK_GROUP = 16


def _mask_lanes(d: int) -> int:
    """Packed-mask lanes of a D-column stream: ceil(D / 16) rounded up to
    32 (the JAX package's layout; lanes past ceil(D / 16) hold 0)."""
    return _ceil_mult(-(-d // _MASK_GROUP), 32)


def _mask_pack(bits):
    """[E, D] bool -> [E, _mask_lanes(D)] f32: lane g holds the exact
    integer sum of 2^(j mod 16) over the set bits j of group g."""
    e, d = bits.shape
    groups = -(-d // _MASK_GROUP)
    padded = torch.zeros((e, groups * _MASK_GROUP), dtype=torch.int32,
                         device=bits.device)
    padded[:, :d] = bits.to(torch.int32)
    weights = 2 ** torch.arange(_MASK_GROUP, dtype=torch.int32,
                                device=bits.device)
    packed = (padded.reshape(e, groups, _MASK_GROUP) * weights).sum(-1)
    out = torch.zeros((e, _mask_lanes(d)), dtype=torch.float32,
                      device=bits.device)
    out[:, :groups] = packed.to(torch.float32)
    return out


def mask_unpack(mask_packed, d: int):
    """Inverse of the pack: [E, lanes] exact-integer f32 -> [E, d] 0/1 f32
    (bit j mod 16 of lane j // 16)."""
    j = torch.arange(d, device=mask_packed.device)
    lanes = mask_packed.to(torch.int32).index_select(1, j // _MASK_GROUP)
    return ((lanes >> (j % _MASK_GROUP)) & 1).to(torch.float32)


def _film_fwd_mask_plain(msgs, gb_table, ranks, act):
    d = msgs.shape[1]
    gb = gb_table.index_select(0, ranks).to(torch.float32)
    z = gb[:, :d] * msgs.to(torch.float32) + gb[:, d:]
    out = torch.zeros((gb_table.shape[0], d), dtype=torch.float32,
                      device=msgs.device)
    out.index_add_(0, ranks, _bf16_terms(_ACTS[act][0](z)))
    return out, _mask_pack(z > 0)


def _masked_segsum_plain(mask_packed, c_e, ranks, table_rows, leak):
    mask = mask_unpack(mask_packed, c_e.shape[1])
    factor = mask if leak == 0.0 else leak + (1.0 - leak) * mask
    out = torch.zeros((table_rows, c_e.shape[1]), dtype=torch.float32,
                      device=c_e.device)
    return out.index_add_(0, ranks,
                          _bf16_terms(c_e.to(torch.float32) * factor))


def _film_fwd_mask_impl(msgs, gb_table, ranks, *, block_edges=256, act,
                        win=0):
    """K15a: K1's table [RPAD, D] f32 (bit for bit) and the packed sign
    mask of z = gamma * m + beta, f32 [E, _mask_lanes(D)] (lane g holds
    the exact integer sum of 2^(j mod 16) over the columns j of group g
    where z > 0), for bf16 m [E, D] and gamma|beta [RPAD, 2D]."""
    e, dim = msgs.shape
    rpad = gb_table.shape[0]
    if gb_table.shape != (rpad, 2 * dim) or ranks.shape != (e,):
        raise ValueError("film_fwd_mask: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(gb_table.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return _film_fwd_mask_plain(msgs, gb_table, ranks, act)
    _check_dtype("film_fwd_mask", msgs, torch.bfloat16)
    _check_dtype("film_fwd_mask", gb_table, torch.bfloat16)
    _check_ranks("film_fwd_mask", ranks)
    lanes = _mask_lanes(dim)
    out = torch.zeros((rpad, dim), dtype=torch.float32, device=msgs.device)
    mask = torch.empty((e, lanes), dtype=torch.float32, device=msgs.device)
    if e:
        _call("film_fwd_mask", (msgs, gb_table, ranks, out, mask),
              (e, dim, lanes, ACT_IDS[act]))
    return out, mask


def _masked_segsum_impl(mask_packed, c_e, ranks, *, table_rows,
                        block_edges=256, leak, win=0):
    """K15b: dt[r] = sum_{rank_e = r} bf16(C_e * factor(mask_e)) f32
    [table_rows, D], factor = mask (relu, leak 0) or leak + (1 - leak) *
    mask (leaky_relu), from the packed mask [E, lanes] of K15a and the bf16
    stream C [E, D] over nondecreasing gap-free int32 ranks (the src-sorted
    stream)."""
    e, dim = c_e.shape
    if (mask_packed.dim() != 2 or mask_packed.shape[0] != e
            or mask_packed.shape[1] * _MASK_GROUP < dim
            or ranks.shape != (e,)):
        raise ValueError("masked_segsum: shapes %s, %s, %s" % (
            tuple(mask_packed.shape), tuple(c_e.shape), tuple(ranks.shape)))
    if c_e.device.type == "cpu":
        return _masked_segsum_plain(mask_packed, c_e, ranks, table_rows, leak)
    _check_dtype("masked_segsum", mask_packed, torch.float32)
    _check_dtype("masked_segsum", c_e, torch.bfloat16)
    _check_ranks("masked_segsum", ranks)
    if not e:
        return torch.zeros((table_rows, dim), dtype=torch.float32,
                           device=c_e.device)
    # The kernel writes every row, those no edge reaches as zeros.
    out = torch.empty((table_rows, dim), dtype=torch.float32,
                      device=c_e.device)
    _masked_segsum_call(mask_packed, c_e, ranks, out, leak)
    return out


def _masked_segsum_call(mask_packed, c_e, ranks, out, leak):
    """K15b's launch into `out` [table_rows, D] (for E > 0), whatever it
    holds: every row is written. The side buffer holds each 64-edge
    chunk's partials of the runs that cross its ends."""
    e, dim = c_e.shape
    side = torch.empty((2 * (-(-e // _ROW_CHUNK)), dim), dtype=torch.float32,
                       device=c_e.device)
    _call("masked_segsum", (mask_packed, c_e, ranks, side, out),
          (e, dim, mask_packed.shape[1], out.shape[0], float(leak)))


# ---- the GNN-Edge-MLP1 kernels (K11, K12) ---------------------------------

def _expand_add_act_impl(m, beta_table, ranks, *, block_edges=256, act,
                         win=0):
    """K11a: x[e] = bf16(act(m_e + bf16(beta[rank_e]))) for a bf16 stream m
    [E, D], an f32 rank table beta [rows, D] and int32 ranks below `rows`;
    bf16 [E, D] out. The table value is rounded to bf16 BEFORE the f32
    add, the sum is activated in f32 and rounded once."""
    e, dim = m.shape
    if (ranks.shape != (e,) or beta_table.dim() != 2
            or beta_table.shape[1] != dim):
        raise ValueError("expand_add_act: shapes %s, %s, %s" % (
            tuple(m.shape), tuple(beta_table.shape), tuple(ranks.shape)))
    if m.device.type == "cpu":
        return _expand_add_act_plain(m, beta_table, ranks, act)
    _check_dtype("expand_add_act", m, torch.bfloat16)
    _check_dtype("expand_add_act", beta_table, torch.float32)
    _check_ranks("expand_add_act", ranks)
    x = torch.empty((e, dim), dtype=torch.bfloat16, device=m.device)
    if e:
        _call("expand_add_act", (m, beta_table, ranks, x),
              (e, dim, ACT_IDS[act]))
    return x


def _expand_add_act_bwd_impl(x, dx, ranks, *, table_rows, block_edges=256,
                             act, win=0):
    """K11b: with dz = bf16(act'(x_e) * dx_e), act' taken from the OUTPUT x
    (`_ACTS_FROM_OUT`), returns (d_m, d_beta): d_m[e] = dz [E, D] bf16 and
    d_beta[r] = sum_{rank_e = r} dz, f32 [table_rows, D] (the ROUNDED dz is
    what both see), from the bf16 streams x and dx [E, D] and
    nondecreasing gap-free int32 ranks."""
    e, dim = x.shape
    if dx.shape != (e, dim) or ranks.shape != (e,):
        raise ValueError("expand_add_act_bwd: shapes %s, %s, %s" % (
            tuple(x.shape), tuple(dx.shape), tuple(ranks.shape)))
    if act not in _ACTS_FROM_OUT:
        raise ValueError("expand_add_act_bwd: the derivative of '%s' is no "
                         "function of its output" % act)
    if x.device.type == "cpu":
        return _expand_add_act_bwd_plain(x, dx, ranks, table_rows, act)
    _check_dtype("expand_add_act_bwd", x, torch.bfloat16)
    _check_dtype("expand_add_act_bwd", dx, torch.bfloat16)
    _check_ranks("expand_add_act_bwd", ranks)
    dm = torch.empty((e, dim), dtype=torch.bfloat16, device=x.device)
    dbeta = torch.zeros((table_rows, dim), dtype=torch.float32,
                        device=x.device)
    if e:
        _call("expand_add_act_bwd", (x, dx, ranks, dm, dbeta),
              (e, dim, ACT_IDS[act]))
    return dm, dbeta


# Slices one K12a launch takes (csrc/act_agg.cu MAX_SLICES); more take
# one launch for each such group.
ACT_AGG_MAX_SLICES = 32


def _act_agg_slices_impl(slices, *, table_rows, act, out=None):
    """K12a over several stream slices: table[r] = sum over the slices'
    edges of rank r of bf16(act(msg_e)), f32 [table_rows, D]. `slices` is
    a non-empty sequence of (bf16 msgs [E_l, D], nondecreasing gap-free
    int32 ranks [E_l] below `table_rows`) whose rank rows are DISJOINT (the
    edge types' slices of the type-major stream): any lengths, ranks that
    start anywhere. One launch takes every non-empty slice, up to
    ACT_AGG_MAX_SLICES of them. `out` is a table to write into in place of
    a new zeroed one; the rows of the slices' ranks must still be zero in
    it."""
    if not slices:
        raise ValueError("act_agg: no slices")
    dim = slices[0][0].shape[-1]
    for msgs, ranks in slices:
        if (msgs.dim() != 2 or msgs.shape[1] != dim
                or ranks.shape != (msgs.shape[0],)):
            raise ValueError("act_agg: shapes %s, %s" % (
                tuple(msgs.shape), tuple(ranks.shape)))
    if out is not None and out.shape != (table_rows, dim):
        raise ValueError("act_agg: out %s, not (%d, %d)" % (
            tuple(out.shape), table_rows, dim))
    dev = slices[0][0].device
    if dev.type == "cpu":
        return _act_agg_slices_plain(slices, table_rows, act, out)
    for msgs, ranks in slices:
        _check_dtype("act_agg", msgs, torch.bfloat16)
        _check_ranks("act_agg", ranks)
        _check_laid_out("act_agg", (msgs, ranks), dev)
    if out is None:
        out = torch.zeros((table_rows, dim), dtype=torch.float32, device=dev)
    _check_dtype("act_agg", out, torch.float32)
    _check_laid_out("act_agg", (out,), dev)
    live = [(m, r) for m, r in slices if r.shape[0]]
    for g in range(0, len(live), ACT_AGG_MAX_SLICES):
        group = live[g:g + ACT_AGG_MAX_SLICES]
        n = len(group)
        _run("act_agg", dev, (
            (ctypes.c_void_p * n)(*(m.data_ptr() for m, _ in group)),
            (ctypes.c_void_p * n)(*(r.data_ptr() for _, r in group)),
            (ctypes.c_int * n)(*(r.shape[0] for _, r in group)), n,
            out.data_ptr(), dim, ACT_IDS[act]))
    return out


def _act_agg_impl(msgs, ranks, *, table_rows, block_edges=256, act, win=0,
                  out=None):
    """K12a on one stream: table[r] = sum_{rank_e = r} bf16(act(msg_e)) for
    a bf16 stream [E, D] and nondecreasing gap-free int32 ranks below
    `table_rows`; f32 [table_rows, D] out (_act_agg_slices_impl of one
    slice)."""
    return _act_agg_slices_impl([(msgs, ranks)], table_rows=table_rows,
                                act=act, out=out)


def _act_agg_bwd_impl(msgs, g16, ranks, *, block_edges=256, act, win=0):
    """K12b: d_msg[e] = bf16(act'(msg_e) * g16[rank_e]), bf16 [E, D], from
    the bf16 stream [E, D], the bf16 table cotangent g16 [rows, D] and
    int32 ranks below `rows`; act' is recomputed in f32 from the message."""
    e, dim = msgs.shape
    if ranks.shape != (e,) or g16.dim() != 2 or g16.shape[1] != dim:
        raise ValueError("act_agg_bwd: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(g16.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return _act_agg_bwd_plain(msgs, g16, ranks, act)
    _check_dtype("act_agg_bwd", msgs, torch.bfloat16)
    _check_dtype("act_agg_bwd", g16, torch.bfloat16)
    _check_ranks("act_agg_bwd", ranks)
    dmsg = torch.empty((e, dim), dtype=torch.bfloat16, device=msgs.device)
    if e:
        _call("act_agg_bwd", (msgs, g16, ranks, dmsg),
              (e, dim, ACT_IDS[act]))
    return dmsg


# ---- the typed dense aggregate (K10) and Edge-MLP1's source pass (K14) ----

def _typed_products(x, w, types):
    """y[e] = float(x_e) @ float(w[type_e]), f32 [E, D_out], one f32 matmul
    per type's edges; an edge whose type is not in [0, L) gets 0."""
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                    device=x.device)
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    for l in range(w.shape[0]):
        sel = (types == l).nonzero(as_tuple=True)[0]
        if sel.numel():
            y.index_copy_(0, sel, torch.matmul(xf.index_select(0, sel), wf[l]))
    return y


def _typed_dense_agg_plain(x, w, types, ranks, table_rows, act):
    out = torch.zeros((table_rows, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    # act(0) = 0 for every activation of _ACTS: an edge of no valid type
    # adds nothing.
    return out.index_add_(
        0, ranks, _bf16_terms(_ACTS[act][0](_typed_products(x, w, types))))


def _typed_dense_agg_bwd_plain(x, w, g16, types, ranks, act):
    n_types = w.shape[0]
    valid = ((types >= 0) & (types < n_types))[:, None]
    y = _typed_products(x, w, types)
    g_e = g16.index_select(0, ranks).to(torch.float32)
    dz = torch.where(valid, _ACTS[act][1](y) * g_e, 0.0).to(torch.bfloat16)
    dx = _typed_products(dz, w.transpose(1, 2), types).to(torch.bfloat16)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    xf, dzf = x.to(torch.float32), dz.to(torch.float32)
    for l in range(n_types):
        sel = (types == l).nonzero(as_tuple=True)[0]
        if sel.numel():
            dw[l] = torch.matmul(xf.index_select(0, sel).t(),
                                 dzf.index_select(0, sel))
    return dx, dw


def _emlp1_src_bwd_plain(gcb_src, t_ranked, type_col, w_stack, e_real, ranks,
                         table_rows, act):
    e = ranks.shape[0]
    d = t_ranked.shape[1]
    m = t_ranked.index_select(0, ranks).to(torch.float32)
    gcb = gcb_src.to(torch.float32)
    x = _elu(m + gcb[:, :d])
    x16 = x.to(torch.bfloat16)
    cols = type_col.index_select(0, ranks)
    dagg = torch.where((cols >= 0)[:, None],
                       _ACTS[act][1](_typed_products(x16, w_stack, cols))
                       * gcb[:, d:], 0.0).to(torch.bfloat16)
    dx = _typed_products(dagg, w_stack.transpose(1, 2), cols)
    dm = _ACTS_FROM_OUT["elu"](x) * dx
    live = torch.arange(e, device=ranks.device) < e_real.to(ranks.device)
    dm = torch.where(live[:, None], dm, 0.0)
    out = torch.zeros((table_rows, d), dtype=torch.float32,
                      device=gcb_src.device)
    return out.index_add_(0, ranks, _bf16_terms(dm))


# What the tensor-core kernels K10a and K10b stage in a block's shared
# memory (csrc/typed_dense_agg.cu, csrc/typed_dense_agg_bwd.cu `smem_bytes`
# and SMEM_MAX; bf16 rows padded to 16 columns plus 8): at most these many
# bytes beside their static arrays, for at most TYPED_MMA_MAX_TYPES edge
# types. A block may opt into SMEM_OPTIN bytes on the H100.
SMEM_OPTIN = 232448
TYPED_MMA_SMEM = {False: SMEM_OPTIN - 5120, True: SMEM_OPTIN - 2048}
TYPED_MMA_MAX_TYPES = 8


def typed_dense_agg_fits(n_types: int, dh: int, d: int, backward: bool
                         ) -> bool:
    """Whether K10a (`backward` False: every type's weights for a column
    tile of at least 16 columns, a 65-row x tile and a 64-row term tile)
    or K10b (two types' weights, two batches' 48 x rows and cotangent rows,
    48 dz rows and a block's 2,048 edges and ranks) fits a block's shared
    memory."""
    if not 1 <= n_types <= TYPED_MMA_MAX_TYPES:
        return False
    dh_p, d_p = _ceil_mult(dh, 16), _ceil_mult(d, 16)
    if backward:
        need = (2 * (2 * dh_p * (d_p + 8) + 96 * (dh_p + 8)
                     + 144 * (d_p + 8)) + 8 * 2048)
    else:
        need = 2 * (n_types * dh_p * 24 + 65 * (dh_p + 8) + 64 * 18)
    return need <= TYPED_MMA_SMEM[backward]


def _typed_dense_agg_impl(x, w, types, ranks, *, table_rows, block_edges=256,
                          act, win=0):
    """K10a: table[r] = sum_{rank_e = r} bf16(act(x_e @ w[type_e])) for a
    bf16 stream x [E, Dh], bf16 weights w [L, Dh, D], int32 types and
    nondecreasing gap-free int32 ranks [E]; f32 [table_rows, D] out. Each
    product sums in f32 (on the card on the tensor cores, for L <= 8 and
    widths that typed_dense_agg_fits); an edge whose type is not in
    [0, L) adds nothing."""
    e, dh = x.shape
    if (w.dim() != 3 or w.shape[1] != dh or types.shape != (e,)
            or ranks.shape != (e,)):
        raise ValueError("typed_dense_agg: shapes %s, %s, %s, %s" % (
            tuple(x.shape), tuple(w.shape), tuple(types.shape),
            tuple(ranks.shape)))
    if x.device.type == "cpu":
        return _typed_dense_agg_plain(x, w, types, ranks, table_rows, act)
    _check_dtype("typed_dense_agg", x, torch.bfloat16)
    _check_dtype("typed_dense_agg", w, torch.bfloat16)
    _check_dtype("typed_dense_agg", types, torch.int32)
    _check_ranks("typed_dense_agg", ranks)
    if not typed_dense_agg_fits(w.shape[0], dh, w.shape[2], False):
        raise ValueError("typed_dense_agg: %d types of %d x %d weights do not "
                         "fit the kernel" % tuple(w.shape))
    out = torch.zeros((table_rows, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    if e:
        _call("typed_dense_agg", (x, w, types, ranks, out),
              (e, dh, w.shape[2], w.shape[0], ACT_IDS[act]))
    return out


def _typed_dense_agg_bwd_impl(x, w, g16, types, ranks, *, block_edges=256,
                              act, win=0):
    """K10b: with y_e = x_e @ w[type_e] recomputed in f32 and dz_e =
    bf16(act'(y_e) * g16[rank_e]), returns dx [E, Dh] bf16, dx_e =
    bf16(dz_e @ w[type_e]^T), and dW [L, Dh, D] f32, dW[l] = sum_{type_e =
    l} x_e^T dz_e, from the bf16 stream x, bf16 weights w, the bf16 table
    cotangent g16 [rows, D], int32 types and ranks. On the card the
    products run on the tensor cores (for L <= 8 and widths that
    typed_dense_agg_fits) and dW sums in another order on every run
    (atomics)."""
    e, dh = x.shape
    if (w.dim() != 3 or w.shape[1] != dh or types.shape != (e,)
            or ranks.shape != (e,) or g16.dim() != 2
            or g16.shape[1] != w.shape[2]):
        raise ValueError("typed_dense_agg_bwd: shapes %s, %s, %s, %s, %s" % (
            tuple(x.shape), tuple(w.shape), tuple(g16.shape),
            tuple(types.shape), tuple(ranks.shape)))
    if x.device.type == "cpu":
        return _typed_dense_agg_bwd_plain(x, w, g16, types, ranks, act)
    _check_dtype("typed_dense_agg_bwd", x, torch.bfloat16)
    _check_dtype("typed_dense_agg_bwd", w, torch.bfloat16)
    _check_dtype("typed_dense_agg_bwd", g16, torch.bfloat16)
    _check_dtype("typed_dense_agg_bwd", types, torch.int32)
    _check_ranks("typed_dense_agg_bwd", ranks)
    if not typed_dense_agg_fits(w.shape[0], dh, w.shape[2], True):
        raise ValueError("typed_dense_agg_bwd: %d types of %d x %d weights "
                         "do not fit the kernel" % tuple(w.shape))
    dx = torch.empty((e, dh), dtype=torch.bfloat16, device=x.device)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    if e:
        _call("typed_dense_agg_bwd", (x, w, g16, types, ranks, dx, dw),
              (e, dh, w.shape[2], w.shape[0], ACT_IDS[act]))
    return dx, dw


# What K14 stages in a block's shared memory (csrc/emlp1_src_bwd.cu
# `smem_bytes` and SMEM_MAX; bf16 rows padded to 16 columns plus 8): every
# non-self type's weights and, for each of its two warp groups, a 32-edge
# chunk's bf16(x), da and g rows (bf16) and elu'(x) rows (f32). The
# kernel's own emlp1_src_bwd_fits is held equal to this one on the card.
EMLP1_SRC_SMEM = SMEM_OPTIN - 3072
EMLP1_SRC_ROWS = 2 * 32  # two warp groups' 32-edge chunks


def emlp1_src_bwd_fits(l_eff: int, d: int) -> bool:
    """Whether K14's block holds `l_eff` types' D x D weights and a chunk's
    rows in shared memory (D up to 128 at four types, the gate's most)."""
    if d <= 0 or not 1 <= l_eff <= TYPED_MMA_MAX_TYPES:
        return False
    d_p = _ceil_mult(d, 16)
    ld = d_p + 8
    need = (2 * (l_eff * d_p * ld + 3 * EMLP1_SRC_ROWS * ld)
            + 4 * EMLP1_SRC_ROWS * ld)
    return need <= EMLP1_SRC_SMEM


def _emlp1_src_bwd_impl(gcb_src, t_ranked, type_col, w_stack, e_real, ranks,
                        *, table_rows, block_edges=256, act, win=0):
    """K14: the source-order half of the Edge-MLP1 backward. Edge e of src
    rank s (ranks [E], nondecreasing and gap-free) reads m = t_ranked[s]
    (bf16 [table_rows, D]), beta | g = gcb_src[e] (bf16 [E, 2D]) and the
    compact non-self type col = type_col[s] (int32 [table_rows]; -1 for a
    self-loop type or a slack row), and recomputes x = elu(m + beta), y =
    bf16(x) @ w_stack[col], dm = elu'(x) * (bf16(act'(y) * g) @
    w_stack[col]^T), all in f32; out[s] = sum bf16(dm), f32 [table_rows,
    D]. Edges at or past e_real (an int32 [1] tensor: the padded tail of
    the src-sorted stream, whose type decode is garbage) and edges of no
    non-self type add nothing. The JAX package takes the type from a
    one-hot over the non-self types; `type_col` is its column index. On
    the card both products run on the tensor cores (for widths that
    emlp1_src_bwd_fits: the wrapper raises past them) and read w_stack
    both ways, so no transposed copy is made."""
    e = ranks.shape[0]
    dim = t_ranked.shape[1]
    if (gcb_src.shape != (e, 2 * dim) or t_ranked.shape[0] != table_rows
            or type_col.shape != (table_rows,) or w_stack.dim() != 3
            or w_stack.shape[1:] != (dim, dim) or e_real.shape != (1,)):
        raise ValueError("emlp1_src_bwd: shapes %s, %s, %s, %s, %s" % (
            tuple(gcb_src.shape), tuple(t_ranked.shape),
            tuple(type_col.shape), tuple(w_stack.shape), tuple(ranks.shape)))
    if gcb_src.device.type == "cpu":
        return _emlp1_src_bwd_plain(gcb_src, t_ranked, type_col, w_stack,
                                    e_real, ranks, table_rows, act)
    _check_dtype("emlp1_src_bwd", gcb_src, torch.bfloat16)
    _check_dtype("emlp1_src_bwd", t_ranked, torch.bfloat16)
    _check_dtype("emlp1_src_bwd", w_stack, torch.bfloat16)
    _check_dtype("emlp1_src_bwd", type_col, torch.int32)
    _check_dtype("emlp1_src_bwd", e_real, torch.int32)
    _check_ranks("emlp1_src_bwd", ranks)
    if not emlp1_src_bwd_fits(w_stack.shape[0], dim):
        raise ValueError("emlp1_src_bwd: %d types of %d x %d weights do not "
                         "fit the kernel" % tuple(w_stack.shape))
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=gcb_src.device)
    if e:
        _call("emlp1_src_bwd", (gcb_src, t_ranked, type_col, w_stack, e_real,
                                ranks, out),
              (e, dim, w_stack.shape[0], ACT_IDS[act]))
    return out


# ---- the head-major attention kernels (K6, K7, K8, K9) -------------------

# Most heads the wrappers of K7a and K7b accept. It is a round number well
# above any config's 8, and within both kernels' own limits: K7a stages
# the ranks and K f32 weights of the up to 4,160 edges of a block's chunks
# in shared memory (at 128 heads at most 182 KB of the 227 KB a block may
# opt into; its earlier body, K x 64 weights in 48 KB: K <= 192), K7b
# gives each (edge, head) pair one of a block's 256 threads (K <= 256).
MAX_HEADS = 128


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


def _wseg_t_dw_impl(msgs, g16, ranks, *, num_heads, block_edges=256, win=0,
                    d_used=None):
    """K8: the d_w_t half of K7b alone, d_w_t[k, e] = sum over head k's
    columns of m_e * g16[rank_e], f32 [K, E], from the bf16 stream m
    [E, D (+ extra)] and the bf16 table cotangent g16 [rows, D]. With
    `d_used` only the first d columns of m are read (the row stays D +
    extra wide)."""
    e, dim_in = msgs.shape
    dim = d_used or dim_in
    if (ranks.shape != (e,) or g16.dim() != 2 or g16.shape[1] != dim
            or dim > dim_in):
        raise ValueError("wseg_t_dw: shapes %s, %s, %s, d_used %s" % (
            tuple(msgs.shape), tuple(g16.shape), tuple(ranks.shape), d_used))
    _check_heads("wseg_t_dw", dim, num_heads)
    if msgs.device.type == "cpu":
        return _wseg_t_dw_plain(msgs, g16, ranks, num_heads, d_used)
    _check_dtype("wseg_t_dw", msgs, torch.bfloat16)
    _check_dtype("wseg_t_dw", g16, torch.bfloat16)
    _check_ranks("wseg_t_dw", ranks)
    dw_t = torch.empty((num_heads, e), dtype=torch.float32,
                       device=msgs.device)
    if e:
        _call("wseg_t_dw", (msgs, g16, ranks, dw_t),
              (e, dim, dim_in, num_heads))
    return dw_t


def _wseg_impl(msgs, w, ranks, *, table_rows, num_heads, block_edges=256,
               win=0):
    """K13a: table[r] = sum_{rank_e = r} bf16(m_e * rep(w[e])) for a bf16
    stream m [E, D], f32 row-major weights w [E, K] (head k weighs columns
    k * D/K ... (k+1) * D/K) and int32 ranks; f32 [table_rows, D] out."""
    e, dim = msgs.shape
    if w.shape != (e, num_heads) or ranks.shape != (e,):
        raise ValueError("wseg: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(w.shape), tuple(ranks.shape)))
    _check_heads("wseg", dim, num_heads)
    if msgs.device.type == "cpu":
        return _wseg_plain(msgs, w, ranks, table_rows)
    _check_dtype("wseg", msgs, torch.bfloat16)
    _check_dtype("wseg", w, torch.float32)
    _check_ranks("wseg", ranks)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=msgs.device)
    if e:
        _call("wseg", (msgs, w, ranks, out), (e, dim, num_heads))
    return out


def _wseg_bwd_impl(msgs, w, g16, ranks, *, num_heads, block_edges=256, win=0):
    """K13b: with g_e = g16[rank_e], d_msgs[e] = bf16(g_e * rep(w[e]))
    [E, D] bf16 and d_w[e, k] = sum over head k's columns of m_e * g_e
    [E, K] f32, from the bf16 stream m [E, D], the f32 row-major weights w
    [E, K] and the bf16 table cotangent g16 [rows, D]."""
    e, dim = msgs.shape
    if (w.shape != (e, num_heads) or ranks.shape != (e,)
            or g16.dim() != 2 or g16.shape[1] != dim):
        raise ValueError("wseg_bwd: shapes %s, %s, %s, %s" % (
            tuple(msgs.shape), tuple(w.shape), tuple(g16.shape),
            tuple(ranks.shape)))
    _check_heads("wseg_bwd", dim, num_heads)
    if msgs.device.type == "cpu":
        return _wseg_bwd_plain(msgs, w, g16, ranks)
    _check_dtype("wseg_bwd", msgs, torch.bfloat16)
    _check_dtype("wseg_bwd", g16, torch.bfloat16)
    _check_dtype("wseg_bwd", w, torch.float32)
    _check_ranks("wseg_bwd", ranks)
    dmsg = torch.empty((e, dim), dtype=torch.bfloat16, device=msgs.device)
    dw = torch.empty((e, num_heads), dtype=torch.float32, device=msgs.device)
    if e:
        _call("wseg_bwd", (msgs, w, g16, ranks, dmsg, dw),
              (e, dim, num_heads))
    return dmsg, dw


# Most heads K9 takes: a block keeps its 64-edge chunk's rows and 2 x 64 x
# K f32 values (the attention weights and logit cotangents) in shared
# memory; at 96 heads the latter alone are 48 KB, what a block gets by
# default, so the launcher opts in to more.
RGAT_SRC_MAX_HEADS = 96


def _rgat_src_bwd_launch(form, rows, fine_key, t_ext, ranks, num_heads,
                         table_rows, rpad, clamp):
    """Launch K9 in `form` ("stream": `rows` the [E, D + 3K] stream and no
    keys; "gather": `rows` the side table, read at `fine_key`) into a new
    zeroed f32 [table_rows, D + K] table."""
    k = num_heads
    dim = t_ext.shape[1] - k
    if k > RGAT_SRC_MAX_HEADS:
        raise ValueError("rgat_src_bwd: at most %d heads, got %d"
                         % (RGAT_SRC_MAX_HEADS, k))
    _check_dtype("rgat_src_bwd", rows, torch.bfloat16)
    _check_dtype("rgat_src_bwd", t_ext, torch.bfloat16)
    _check_ranks("rgat_src_bwd", ranks)
    if fine_key is not None:
        _check_ranks("rgat_src_bwd", fine_key)
    out = torch.zeros((table_rows, dim + k), dtype=torch.float32,
                      device=rows.device)
    e = ranks.shape[0]
    if e:
        gather = form == "gather"
        _call("rgat_src_bwd",
              (None if gather else rows, rows if gather else None, fine_key,
               t_ext, ranks, out),
              (e, dim, k, rpad, float(clamp)))
        FORM_LAUNCHES["rgat_src_bwd " + form] += 1
    return out


def _rgat_src_bwd_impl(gcb_src, t_ext, ranks, *, table_rows, num_heads,
                       block_edges=256, clamp, win=0):
    """K9: RGAT's backward over the src-sorted stream. Edge e of src rank
    s reads m | lsrc = t_ext[s] (bf16 [R_src, D + K]: the src-rank message
    rows with their source logit halves, the forward's own values) and
    dagg | lt | den | s_cor = gcb_src[e] (bf16 [E, D + 3K]: its receiver's
    aggregation cotangent, target logit half, softmax denominator and
    correction term), recomputes attn = exp(clip(leaky(lsrc + lt))) / (den
    + 1e-7) and the logit cotangent dpre, and sums per rank: out[s] = sum
    bf16(rep(attn) * dagg) | bf16(dpre), f32 [R_src, D + K]. Padded edges
    and fill slots read a zero gcb row and add zeros."""
    e, k = ranks.shape[0], num_heads
    dim = t_ext.shape[1] - k
    if (ranks.dim() != 1 or t_ext.dim() != 2 or dim <= 0
            or gcb_src.shape != (e, dim + 3 * k)
            or t_ext.shape[0] != table_rows):
        raise ValueError("rgat_src_bwd: shapes %s, %s, %s" % (
            tuple(gcb_src.shape), tuple(t_ext.shape), tuple(ranks.shape)))
    _check_heads("rgat_src_bwd", dim, k)
    if gcb_src.device.type == "cpu":
        return _rgat_src_bwd_plain(gcb_src, t_ext, ranks, table_rows, k,
                                   clamp)
    return _rgat_src_bwd_launch("stream", gcb_src, None, t_ext, ranks, k,
                                table_rows, 0, clamp)


def _rgat_src_bwd_gather_impl(side, fine_key, t_ext, ranks, *, table_rows,
                              num_heads, clamp):
    """K9 reading each edge's dagg | lt | den | s_cor row of the bf16
    [RPAD, D + 3K] side table at its fine key (int32 [E]; a key outside
    [0, RPAD), the diluted stream's SD_FILL slots, reads nothing and adds
    exact zeros), t_ext and the src ranks as _rgat_src_bwd_impl takes
    them; f32 [table_rows, D + K] out. Equals _rgat_src_bwd_impl on
    _side_rows' stream without building it."""
    e, k = ranks.shape[0], num_heads
    dim = t_ext.shape[1] - k
    if (ranks.dim() != 1 or t_ext.dim() != 2 or dim <= 0 or side.dim() != 2
            or side.shape[1] != dim + 3 * k or fine_key.shape != (e,)
            or t_ext.shape[0] != table_rows):
        raise ValueError("rgat_src_bwd (gather): shapes %s, %s, %s, %s" % (
            tuple(side.shape), tuple(fine_key.shape), tuple(t_ext.shape),
            tuple(ranks.shape)))
    _check_heads("rgat_src_bwd", dim, k)
    if side.device.type == "cpu":
        return _rgat_src_bwd_gather_plain(side, fine_key, t_ext, ranks,
                                          table_rows, k, clamp)
    return _rgat_src_bwd_launch("gather", side, fine_key, t_ext, ranks, k,
                                table_rows, side.shape[0], clamp)


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


class _RankedWeightedSegmentSum(torch.autograd.Function):
    """K13a forward; K13b backward on the table cotangent rounded to bf16,
    each half cast back to its primal's dtype (the JAX package's
    ranked_weighted_segment_sum, _wseg_vjp_fwd / _wseg_vjp_bwd)."""

    @staticmethod
    def forward(ctx, msgs, w, ranks, table_rows, num_heads):
        ctx.save_for_backward(msgs, w, ranks)
        ctx.num_heads = num_heads
        return _wseg_impl(msgs, w, ranks, table_rows=table_rows,
                          num_heads=num_heads)

    @staticmethod
    def backward(ctx, g):
        msgs, w, ranks = ctx.saved_tensors
        d_msgs, d_w = _wseg_bwd_impl(
            msgs, w, g.to(torch.bfloat16).contiguous(), ranks,
            num_heads=ctx.num_heads)
        return d_msgs.to(msgs.dtype), d_w.to(w.dtype), None, None, None


def ranked_weighted_segment_sum(msgs, w, ranks, table_rows: int,
                                num_heads: int):
    """Per-head weighted segment-sum with row-major weights: table[r] =
    sum_{rank_e = r} m_e * rep(w[e]), [E, D] x [E, K] -> [table_rows, D]
    f32. VJP: d_msgs (in msgs' dtype) and d_w. No layer of either package
    calls it (RGAT takes the head-major ranked_weighted_segment_sum_t)."""
    return _RankedWeightedSegmentSum.apply(msgs, w, ranks, table_rows,
                                           num_heads)


# ---- the gather-fused FiLM pass ---------------------------------------

def _clip(idx, rows: int):
    """jnp.take(..., mode="clip") index semantics: padded edges carry
    src_flat = L * n_pad, one row past the table."""
    return idx.clamp(0, rows - 1)


def _zero_extended(table):
    """`table` with 8 zero rows appended (the JAX package's count)."""
    return torch.nn.functional.pad(table, (0, 0, 0, 8))


class _FilmFusedSrcPass(torch.autograd.Function):
    """FiLM message pass with the source-side gather fused into the
    backward (the JAX package's film_fused_src_pass, _ffsp_fwd/_ffsp_bwd).

    Forward: m = t_flat[src_idx] (bf16), then K1 over fine ranks.
    Backward: K2 gives d_gamma|d_beta in receiver order; dt is recomputed
    in SOURCE order by K3 from the small tables (gamma|beta and g read per
    edge at its fine rank, C = gamma * g formed in the kernel, t rows read
    by src rank), so no [E, D] cotangent is permuted between edge orders
    and no per-edge stream is built for K3. `fine_rank_by_src`
    and `src_sorted_rank` are the src stream of nn/layers.py src_stream:
    undiluted [E], or diluted [E_sd] with SD_FILL fine keys. Returns d_t in
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
        g16 = g.to(torch.bfloat16).contiguous()
        dgb = _film_bwd_dgb_split_impl(m, gb16, g16, ranks, act=ctx.act)
        # The diluted stream's fill slots (SD_FILL fine keys, past the
        # table) add zero whatever the cotangent; real and padded edges
        # key rows of the table.
        dt_table = _film_src_bwd_gather_impl(
            gb16, g16, fine_rank_by_src, t16, src_from_rank, src_sorted_rank,
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


# Escape hatch for debugging, as in the JAX package: False sends GNN-FiLM's
# and RGAT's gather-fused passes back to their streamed forms.
ENABLE_FUSED_SRC_PASS = True


def film_fused_src_supported(act: str) -> bool:
    """Eligibility of the gather-fused FiLM pass: the JAX package's gate
    without its VMEM terms."""
    return ENABLE_FUSED_SRC_PASS and act in _ACTS


# ---- the FiLM aggregation with a per-edge message cotangent ---------------

def film_column_splits(num_edges: int, dim: int, table_rows: int) -> int:
    """Column-split count of the FiLM aggregation. The JAX package splits
    the (elementwise in d) modulation into 2 or 4 column slices where its
    tables do not fit its on-chip memory whole; the CUDA kernels keep no
    table on chip, so every shape runs unsplit."""
    return 1


class _FilmRankedAggregate(torch.autograd.Function):
    """K1 forward, K4 backward (the JAX package's film_ranked_aggregate,
    _film_vjp_fwd / _film_vjp_bwd): d_msgs in the stream's dtype, d_gb in
    the table's."""

    @staticmethod
    def forward(ctx, msgs, gb_table, ranks, act):
        gb16 = gb_table.to(torch.bfloat16)
        ctx.save_for_backward(msgs, gb16, ranks)
        ctx.act, ctx.gb_dtype = act, gb_table.dtype
        return _film_fwd_impl(msgs, gb16, ranks, act=act)

    @staticmethod
    def backward(ctx, g):
        msgs, gb16, ranks = ctx.saved_tensors
        d_msgs, d_gb = _film_bwd_split_impl(
            msgs, gb16, g.to(torch.bfloat16).contiguous(), ranks, act=ctx.act)
        return d_msgs.to(msgs.dtype), d_gb.to(ctx.gb_dtype), None, None


def film_ranked_aggregate(msgs, gb_table, ranks, act: str = "relu"):
    """Fused GNN-FiLM message pass over an already gathered stream:
    table[r] = sum_{rank_e = r} act(gamma[r] * msgs[e] + beta[r]) with
    gb_table = gamma | beta, rank-indexed [RPAD, 2D], and `ranks` the FINE
    (receiver, type) ranks; f32 [RPAD, D] out. The backward recomputes the
    modulation and returns d_msgs [E, D] and d_gb_table [RPAD, 2D]."""
    return _FilmRankedAggregate.apply(msgs, gb_table, ranks, act.lower())


# ---- GNN-Edge-MLP1: expand-add-activate and activate-aggregate ------------

class _ExpandAddAct(torch.autograd.Function):
    """K11a forward, K11b backward on the cotangent cast to bf16 (the JAX
    package's expand_add_act, _eaa_fwd / _eaa_bwd): the only residual is
    the output x itself."""

    @staticmethod
    def forward(ctx, m, beta_table, ranks, act):
        x = _expand_add_act_impl(m, beta_table, ranks, act=act)
        ctx.save_for_backward(x, ranks)
        ctx.act, ctx.rows = act, beta_table.shape[0]
        ctx.m_dtype, ctx.beta_dtype = m.dtype, beta_table.dtype
        return x

    @staticmethod
    def backward(ctx, g):
        x, ranks = ctx.saved_tensors
        dm, dbeta = _expand_add_act_bwd_impl(
            x, g.to(torch.bfloat16).contiguous(), ranks, table_rows=ctx.rows,
            act=ctx.act)
        return dm.to(ctx.m_dtype), dbeta.to(ctx.beta_dtype), None, None


def expand_add_act(m, beta_table, ranks, act: str):
    """x[e] = act(m[e] + beta_table[rank_e]), bf16 [E, D], with the
    rank-indexed f32 table expanded inside the kernel: neither an [E, D]
    beta stream nor an activation residual exists in device memory (the
    backward recovers act' from x). `act` must be in _ACTS_FROM_OUT; the
    backward returns d_m (bf16) and the d_beta rank table."""
    act = act.lower()
    if not expand_add_act_supported(act):
        raise ValueError("expand_add_act: unsupported activation '%s'" % act)
    return _ExpandAddAct.apply(m, beta_table, ranks, act)


class _ActRankedAggregate(torch.autograd.Function):
    """K12a forward, one launch over all the stream slices, and K12b
    backward, once per slice, on the table cotangent cast to bf16 (the JAX
    package's act_ranked_aggregate, _aagg_fwd / _aagg_bwd, summed over the
    slices)."""

    @staticmethod
    def forward(ctx, table_rows, act, num_slices, *streams_and_ranks):
        streams = streams_and_ranks[:num_slices]
        ranks = streams_and_ranks[num_slices:]
        ctx.save_for_backward(*streams_and_ranks)
        ctx.act, ctx.num_slices = act, num_slices
        return _act_agg_slices_impl(list(zip(streams, ranks)),
                                    table_rows=table_rows, act=act)

    @staticmethod
    def backward(ctx, g):
        streams = ctx.saved_tensors[:ctx.num_slices]
        ranks = ctx.saved_tensors[ctx.num_slices:]
        g16 = g.to(torch.bfloat16).contiguous()
        d_streams = [
            _act_agg_bwd_impl(msgs, g16, rk, act=ctx.act).to(msgs.dtype)
            for msgs, rk in zip(streams, ranks)]
        return (None, None, None, *d_streams, *([None] * ctx.num_slices))


def act_ranked_aggregate_slices(slices, table_rows: int, act: str = "relu"):
    """act_ranked_aggregate of several stream slices whose rank rows are
    DISJOINT (the edge types' slices of the type-major stream), summed:
    `slices` is a sequence of (msgs, ranks). The JAX package adds up one
    whole table per slice; with disjoint rows that sum only ever adds
    zeros, so here every slice's kernel writes into the one table (the
    same values, without a zero fill, an add and a cotangent cast of the
    whole table per slice), in one K12a launch."""
    streams, ranks = zip(*slices)
    return _ActRankedAggregate.apply(table_rows, act.lower(), len(slices),
                                     *streams, *ranks)


def act_ranked_aggregate(msgs, ranks, table_rows: int, act: str = "relu"):
    """table[r] = sum_{rank_e = r} act(msgs[e]), f32 [table_rows, D]: the
    fused FiLM aggregate without the modulation tables (GNN-Edge-MLP's
    outer activation on messages). The backward is one d_msgs-only pass
    that recomputes act' and expands the table cotangent."""
    return act_ranked_aggregate_slices([(msgs, ranks)], table_rows, act)


# ---- the typed dense aggregate (GNN-Edge-MLP1's `fused1` branch) ----------

def typed_dense_agg_supported(n_types: int, act: str, dh: int, d: int
                              ) -> bool:
    """Eligibility of the typed dense aggregate for stacked weights [n_types,
    dh, d]: the JAX package's gate with its semantic terms (a known
    activation; at most 8 types, so that VarMisuse-scale type counts go
    where they go there) and, in place of its VMEM term, what K10a's and
    K10b's blocks hold (typed_dense_agg_fits both ways: Dh = D up to 160;
    the wrappers raise past it). Its stream-length term is dropped: the
    CUDA kernels walk any stream. Wider configs take the plain branch."""
    return (act in _ACTS and n_types <= 8
            and typed_dense_agg_fits(n_types, dh, d, False)
            and typed_dense_agg_fits(n_types, dh, d, True))


class _TypedDenseAggregate(torch.autograd.Function):
    """K10a forward, K10b backward on the table cotangent cast to bf16 (the
    JAX package's typed_dense_aggregate, _tda_fwd / _tda_bwd): the weights
    are rounded to bf16 once and dW comes back in w's dtype."""

    @staticmethod
    def forward(ctx, x, w, types, ranks, table_rows, act):
        w16 = w.to(torch.bfloat16)
        ctx.save_for_backward(x, w16, types, ranks)
        ctx.act, ctx.w_dtype = act, w.dtype
        return _typed_dense_agg_impl(x, w16.contiguous(), types, ranks,
                                     table_rows=table_rows, act=act)

    @staticmethod
    def backward(ctx, g):
        x, w16, types, ranks = ctx.saved_tensors
        dx, dw = _typed_dense_agg_bwd_impl(
            x, w16.contiguous(), g.to(torch.bfloat16).contiguous(), types,
            ranks, act=ctx.act)
        return dx.to(x.dtype), dw.to(ctx.w_dtype), None, None, None, None


def typed_dense_aggregate(x, w, types, ranks, table_rows: int,
                          act: str = "relu"):
    """table[r] = sum_{rank_e = r} act(x_e @ w[type_e]), f32 [table_rows,
    D], for a receiver-sorted bf16 stream x [E, Dh] with gap-free coarse
    ranks, per-edge types and stacked weights w [L, Dh, D]: the per-edge
    typed dense stage, its activation and the aggregation in one pass, so
    the [E, D] post-dense stream never exists in device memory; the
    backward recomputes it."""
    return _TypedDenseAggregate.apply(x, w, types, ranks, table_rows,
                                      act.lower())


# ---- the type-major Edge-MLP1 pass with a source-order backward (K14) -------

# Off by default, as in the JAX package, which measured this pass slower
# than the [E, D] cotangent permute it replaces on its TPU (the W1 dense
# sits between the activation and the transport, so the recompute runs the
# per-edge products again). `chip_smoke.py` and the tests switch it on.
ENABLE_EMLP1_SRC_PASS = False


def emlp1_src_supported(act: str, dim: int, l_eff: int) -> bool:
    """Eligibility of the Edge-MLP1 source-order recompute backward for
    `l_eff` non-self edge types of width `dim`: the JAX package's gate
    with its semantic terms (the flag, a known activation, 1 to 4 non-self
    types) and, in place of its VMEM term, K14's shared memory
    (emlp1_src_bwd_fits: D up to 128 at four types); without its
    stream-length and slice-alignment terms (the CUDA kernels keep no
    table on chip and K12a takes any slice). Wider configs take the
    default type-major step."""
    return (ENABLE_EMLP1_SRC_PASS and ENABLE_FUSED_SRC_PASS
            and act in _ACTS and 0 < l_eff <= 4
            and emlp1_src_bwd_fits(l_eff, dim))


def src_rank_type_columns(src_from_rank, n_pad: int, self_flags):
    """Each src rank's compact non-self edge type, int32 [R_src]: the
    index of its type among the non-self types, -1 for a self-loop type
    (whose messages are combined node-side). The type of a src rank is
    its node-table row // n_pad."""
    num_types = len(self_flags)
    nonself = [l for l, s in enumerate(self_flags) if not s]
    col_of_type = torch.full((num_types + 1,), -1, dtype=torch.int32,
                             device=src_from_rank.device)
    col_of_type[nonself] = torch.arange(len(nonself), dtype=torch.int32,
                                        device=src_from_rank.device)
    return col_of_type.index_select(
        0, torch.clamp(src_from_rank // n_pad, max=num_types).long())


def emlp1_tm_forward(m, beta_table, w1, tm_rank, offs, self_flags,
                     act: str, table_rows: int):
    """The type-major Edge-MLP1 forward from the gathered bf16 source
    halves m [E, D]: x = elu(m + beta_table[rank]) (K11a), one bf16 product
    per non-self type's slice of x and the outer activation and the
    aggregation of each slice (K12a) into one (type, receiver) rank table,
    f32 [table_rows, D]. Returns (table, x, the non-self slices' products).
    Differentiable through K11b, the products and K12b; emlp1_tm_pass runs
    it with grad mode off and brings its own backward."""
    x = expand_add_act(m, beta_table, tm_rank, "elu")
    slices = [(torch.matmul(x[offs[l]:offs[l + 1]], w1[l].to(torch.bfloat16)),
               tm_rank[offs[l]:offs[l + 1]])
              for l, is_self in enumerate(self_flags) if not is_self]
    if slices:
        table = act_ranked_aggregate_slices(slices, table_rows, act)
    else:
        table = torch.zeros((table_rows, m.shape[1]), dtype=torch.float32,
                            device=m.device)
    return table, x, [y for y, _ in slices]


class _Emlp1TmPass(torch.autograd.Function):
    """The JAX package's emlp1_tm_pass (_emlp1_vjp_fwd / _emlp1_vjp_bwd)."""

    @staticmethod
    def forward(ctx, ts_flat, beta_table, w1, src_idx, tm_rank,
                tm_rank_by_src, src_sorted_rank, src_to_rank, src_from_rank,
                edge_mask, offs, self_flags, act, n_pad, table_rows):
        ts16 = ts_flat.to(torch.bfloat16)
        m = ts16.index_select(0, _clip(src_idx, ts16.shape[0]))
        table, x, ys = emlp1_tm_forward(m, beta_table, w1, tm_rank, offs,
                                        self_flags, act, table_rows)
        ctx.save_for_backward(ts16, x, beta_table, w1, tm_rank,
                              tm_rank_by_src, src_sorted_rank, src_to_rank,
                              src_from_rank, edge_mask, *ys)
        ctx.offs, ctx.self_flags, ctx.act = offs, self_flags, act
        ctx.n_pad, ctx.table_rows = n_pad, table_rows
        ctx.ts_dtype = ts_flat.dtype
        return table

    @staticmethod
    def backward(ctx, g):
        (ts16, x, beta_table, w1, tm_rank, tm_rank_by_src, src_sorted_rank,
         src_to_rank, src_from_rank, edge_mask, *ys) = ctx.saved_tensors
        offs, self_flags, act = ctx.offs, ctx.self_flags, ctx.act
        nonself = [l for l, s in enumerate(self_flags) if not s]
        g16 = g.to(torch.bfloat16).contiguous()

        # Receiver-order half: per non-self type the activation cotangent
        # (K12b), dW1 and dx as plain products (outside any kernel, as the
        # JAX package leaves them to XLA), then dbeta through K11b.
        dx = torch.zeros_like(x)
        dw1 = torch.zeros(w1.shape, dtype=torch.float32, device=w1.device)
        for l, y_l in zip(nonself, ys):
            a, b = offs[l], offs[l + 1]
            dy_l = _act_agg_bwd_impl(y_l, g16, tm_rank[a:b], act=act)
            dw1[l] = torch.matmul(x[a:b].t().to(torch.float32),
                                  dy_l.to(torch.float32))
            dx[a:b] = torch.matmul(dy_l, w1[l].to(torch.bfloat16).t())
        _, dbeta = _expand_add_act_bwd_impl(x, dx, tm_rank,
                                            table_rows=ctx.table_rows,
                                            act="elu")

        # Source-order half: one [E, 2D] bf16 gather of beta | g keyed by
        # the (type, receiver) rank of each src-sorted edge, the t rows per
        # src rank, and each src rank's compact non-self type (-1 for a
        # self-loop type: its recomputed dm is zero); K14 sums dm into the
        # src rank table, so no [E, D] cotangent is permuted.
        side = torch.cat([beta_table.to(torch.bfloat16), g16], dim=1)
        gcb_src = side.index_select(0, _clip(tm_rank_by_src, side.shape[0]))
        t_ranked = ts16.index_select(0, _clip(src_from_rank, ts16.shape[0]))
        type_col = src_rank_type_columns(src_from_rank, ctx.n_pad, self_flags)
        w_stack = w1[nonself].to(torch.bfloat16).contiguous()
        e_real = edge_mask.sum().to(torch.int32).reshape(1)
        dt_table = _emlp1_src_bwd_impl(
            gcb_src, t_ranked, type_col, w_stack, e_real, src_sorted_rank,
            table_rows=src_from_rank.shape[0], act=act)
        d_ts = dt_table.index_select(0, src_to_rank.clamp(min=0))
        d_ts = torch.where((src_to_rank >= 0)[:, None], d_ts, 0.0)
        return (d_ts.to(ctx.ts_dtype), dbeta.to(beta_table.dtype),
                dw1.to(w1.dtype), None, None, None, None, None, None, None,
                None, None, None, None, None)


def emlp1_tm_pass(ts_flat, beta_table, w1, src_idx, tm_rank, tm_rank_by_src,
                  src_sorted_rank, src_to_rank, src_from_rank, edge_mask,
                  offs, self_flags, act: str, n_pad: int, table_rows: int):
    """GNN-Edge-MLP1's message pass over the TYPE-MAJOR stream with the
    source-side gather fused into the backward; returns the (type,
    receiver) rank table [table_rows, D] f32. Self-loop types contribute
    node-side outside this op.

    Forward: the tmajor1 pipeline (K11a, a bf16 product per non-self
    type's slice, K12a into one table), from the type-stacked source
    halves `ts_flat` [L * n_pad, D] and the rank table of the target
    halves `beta_table`. Backward: the receiver-order half (K12b per
    non-self type, the dW1 and dx products, K11b) and, in place of the
    [E, D] cotangent permute of the type-major gather, the source-order
    recompute K14."""
    return _Emlp1TmPass.apply(
        ts_flat, beta_table, w1, src_idx, tm_rank, tm_rank_by_src,
        src_sorted_rank, src_to_rank, src_from_rank, edge_mask, tuple(offs),
        tuple(self_flags), act.lower(), n_pad, table_rows)

# ---- the fused RGAT attention pass (src-order recompute backward) ---------

def rgat_fused_supported(num_edges: int, dim: int, num_heads: int,
                         table_rows: int, src_rows: int) -> bool:
    """Whether RGAT takes the fused pass rather than the streamed
    pipeline: the JAX package's gate without its VMEM terms (the CUDA
    kernels keep no table on chip), where the type-stacked node table
    (L * n_pad rows, which `src_rows` is cut from) is shorter than the
    edge stream.

    The fused pass works node-side where the streamed one works per edge
    (the source logits, the widened [L * n_pad, D + K] table, the
    completion of the message cotangent per src rank), so which of the
    two is lighter on the card depends on that ratio. Measured on one
    NVIDIA H100 80GB HBM3 at 700.00 W by `chip_smoke.py`
    (rgat_branch_phase; see PERF.md), at 8 heads and 128 columns, both
    branches in turns within one run. On the tuned QM9 batch (161,792
    edges, 256,000 table rows) the card is busy 37.38 ms of a fused train
    step and 32.30 ms of a streamed one; on the device timeline, where
    both steps wait for the host's launches and the readings scatter with
    the host, the medians read 52.86 ms fused against 44.07 ms streamed
    (eval step 13.64 against 13.72 ms), and the streamed turn was the
    faster one in 13 of 16 neighbouring pairs of turns over four such
    readings. On one layer's forward and backward on a graph of PPI-like
    degree (237,568 edges, 24,576 table rows) the card is busy 1.15 ms
    fused and 1.49 ms streamed, and the timeline told them apart in
    neither direction (4.79 against 4.51 ms). The rule follows the busy
    times and is the same on the CPU, so that a batch takes the same
    branch on every device."""
    if not ENABLE_FUSED_SRC_PASS or dim % num_heads:
        return False
    return src_rows < src_rank_table_rows(num_edges, num_edges)


def _rgat_fwd_compute(t_flat, lt_table, att_src, src_idx, rcv_rank, tgt_rank,
                      edge_mask, num_heads, n_pad, clamp: float = 50.0):
    num_types, k, dh = att_src.shape
    d = t_flat.shape[1]
    t16 = t_flat.to(torch.bfloat16)
    # Per-(type, node) source logit halves, computed NODE-side and rounded
    # to bf16 ONCE: they ride the type-stacked table as K extra columns, so
    # one widened gather brings them to the edges, and the src-order
    # backward reads the SAME bf16 values back.
    lsrc_node = torch.einsum(
        "lnkh,lkh->lnk",
        t16.to(torch.float32).reshape(num_types, n_pad, k, dh),
        _bf16_terms(att_src)).reshape(num_types * n_pad, k)
    t_ext = torch.cat([t16, lsrc_node.to(torch.bfloat16)], dim=1)
    m2e = t_ext.index_select(0, _clip(src_idx, t_ext.shape[0]))  # [E, D+K]
    lsrc_t = m2e[:, d:].to(torch.float32).t().contiguous()
    ltgt_t = _expand_t_impl(lt_table.t().contiguous(), tgt_rank)
    pre_t = lsrc_t + ltgt_t
    logits_t = torch.where(pre_t > 0, pre_t, 0.2 * pre_t)
    ex_t = torch.exp(logits_t.clamp(-clamp, clamp)) * edge_mask[None, :]
    rows = rank_table_rows(n_pad, 256)
    den = _segsum_t_impl(ex_t, rcv_rank, table_rows=rows)
    attn_t = ex_t / (_expand_t_impl(den, rcv_rank) + SMALL_NUMBER)
    # The [E, D+K] gather feeds K7a unsliced (d_used).
    table = _wseg_t_impl(m2e, attn_t, rcv_rank, table_rows=rows,
                         num_heads=num_heads, d_used=d)
    # 3-state leaky/clamp code for the backward: 0 = clamped (no
    # gradient), 1 = positive branch, 2 = negative (0.2x) branch.
    sign = torch.where(logits_t.abs() < clamp,
                       torch.where(pre_t > 0, 1, 2), 0).to(torch.int8)
    return table, (m2e, attn_t, den, sign, t_ext)


class _RgatFusedPass(torch.autograd.Function):
    """The JAX package's rgat_fused_pass (_rgat_vjp_fwd / _rgat_vjp_bwd)."""

    @staticmethod
    def forward(ctx, t_flat, lt_table, att_src, src_idx, fine_rank_by_src,
                src_sorted_rank, src_to_rank, src_from_rank, rcv_rank,
                tgt_rank, edge_mask, fine_to_rcv, node_to_rank, num_heads,
                n_pad):
        table, (m2e, attn_t, den, sign, t_ext) = _rgat_fwd_compute(
            t_flat, lt_table, att_src, src_idx, rcv_rank, tgt_rank,
            edge_mask, num_heads, n_pad)
        ctx.save_for_backward(m2e, attn_t, den, sign, t_ext, lt_table,
                              att_src, fine_rank_by_src, src_sorted_rank,
                              src_to_rank, src_from_rank, rcv_rank, tgt_rank,
                              fine_to_rcv, node_to_rank)
        ctx.num_heads, ctx.n_pad, ctx.t_dtype = num_heads, n_pad, t_flat.dtype
        return table

    @staticmethod
    def backward(ctx, g):
        (m2e, attn_t, den, sign, t_ext, lt_table, att_src, fine_rank_by_src,
         src_sorted_rank, src_to_rank, src_from_rank, rcv_rank, tgt_rank,
         fine_to_rcv, node_to_rank) = ctx.saved_tensors
        k, n_pad = ctx.num_heads, ctx.n_pad
        num_types, _, dh = att_src.shape
        d = m2e.shape[1] - k
        rows = rank_table_rows(n_pad, 256)
        rpad = lt_table.shape[0]
        g16 = g.to(torch.bfloat16)

        # Receiver-order half: raw attention cotangents (K8), the softmax
        # correction table and the fine-rank d(lt_table), all narrow [K, E]
        # math.
        draw_t = _wseg_t_dw_impl(m2e, g16, rcv_rank, num_heads=k, d_used=d)
        s_tab = _segsum_t_impl(attn_t * draw_t, rcv_rank, table_rows=rows)
        s_exp = _expand_t_impl(s_tab, rcv_rank)
        lrfac = torch.where(sign == 1, 1.0, torch.where(sign == 2, 0.2, 0.0))
        dpre_t = attn_t * (draw_t - s_exp) * lrfac
        d_lt = _segsum_t_impl(dpre_t, tgt_rank, table_rows=rpad).t()

        # Source-order half: one [RPAD, D+3K] bf16 side table holds every
        # receiver-keyed value an edge needs; K9 reads each src-sorted
        # edge's row at its fine key. Dump fine ranks (fine_to_rcv ==
        # n_pad: padded edges) read the coarse table's LAST slack row, whose
        # cotangent, denominator and correction are structurally zero, so
        # their dmsg and dpre vanish without a positional mask.
        cof = torch.where(
            fine_to_rcv >= n_pad, rows - 1,
            node_to_rank.index_select(0, fine_to_rcv.clamp(max=n_pad - 1)))
        side = torch.cat([
            g16.index_select(0, cof),
            lt_table.to(torch.bfloat16),
            den.t().to(torch.bfloat16).index_select(0, cof),
            s_tab.t().to(torch.bfloat16).index_select(0, cof),
        ], dim=1)
        # The diluted stream's fill slots (SD_FILL fine keys, outside the
        # table) read nothing and add zeros.
        t_rank_ext = t_ext.index_select(0, _clip(src_from_rank,
                                                 t_ext.shape[0]))
        dtp = _rgat_src_bwd_gather_impl(side, fine_rank_by_src, t_rank_ext,
                                        src_sorted_rank,
                                        table_rows=src_from_rank.shape[0],
                                        num_heads=k, clamp=50.0)
        dt_table, dp_table = dtp[:, :d], dtp[:, d:]
        # Node-side completion from the per-rank dpre sums (m and the
        # type's attention vector are constant within a src rank, an exact
        # reassociation): the att_src-weighted half of the message
        # cotangent, and d_att_src. Plain products, outside any kernel.
        type_oh_rank = torch.nn.functional.one_hot(
            (src_from_rank // n_pad).long(), num_types).to(torch.float32)
        att_block = _bf16_terms(att_src.reshape(num_types, d))
        attv_rank = torch.matmul(type_oh_rank, att_block)  # [R, D]
        dpre_rep_rank = dp_table.repeat_interleave(dh, dim=1)  # [R, D]
        dt_full = dt_table + attv_rank * dpre_rep_rank
        d_att_block = torch.matmul(
            type_oh_rank.t(),
            t_rank_ext[:, :d].to(torch.float32) * dpre_rep_rank)  # [L, D]
        d_t = dt_full.index_select(0, src_to_rank.clamp(min=0))
        d_t = torch.where((src_to_rank >= 0)[:, None], d_t, 0.0)
        return (d_t.to(ctx.t_dtype), d_lt.to(lt_table.dtype),
                d_att_block.reshape(num_types, k, dh).to(att_src.dtype),
                None, None, None, None, None, None, None, None, None, None,
                None, None)


def rgat_fused_pass(t_flat, lt_table, att_src, src_idx, fine_rank_by_src,
                    src_sorted_rank, src_to_rank, src_from_rank, rcv_rank,
                    tgt_rank, edge_mask, fine_to_rcv, node_to_rank,
                    num_heads: int, n_pad: int):
    """RGAT attention pass with the source-side gather fused into the
    backward; returns the coarse rank table [rows, D] f32 (before the
    activation).

    Forward: messages gathered once from the type-stacked transform table
    `t_flat` [L * n_pad, D], widened by the node-side source logit halves
    (`att_src` [L, K, D / K], rounded to bf16); target halves expanded from
    the fine-rank `lt_table` [RPAD, K] (K6b); clamped-exp receiver softmax
    (K6a, K6b); weighted aggregation (K7a).

    Backward: no [E, D] cotangent is permuted between edge orders. K8 gives
    the raw per-edge attention cotangents, narrow [K, E] math and two
    ranked segment-sums (K6a) the softmax correction table and
    d(lt_table), and K9 recomputes attention and logit cotangents in
    SOURCE order, reading each edge's row of one [RPAD, D+3K] bf16 side
    table at its fine key, and sums the message cotangent straight into
    the src rank table. `fine_rank_by_src` and
    `src_sorted_rank` are the src stream of nn/layers.py src_stream.
    Receiver-keyed values ride bf16 through the side table."""
    return _RgatFusedPass.apply(
        t_flat, lt_table, att_src, src_idx, fine_rank_by_src,
        src_sorted_rank, src_to_rank, src_from_rank, rcv_rank, tgt_rank,
        edge_mask, fine_to_rcv, node_to_rank, num_heads, n_pad)
