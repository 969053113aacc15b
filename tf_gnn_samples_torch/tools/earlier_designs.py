"""The earlier designs of K3 (`film_src_bwd`), K4 (`film_bwd`), K12a
(`act_agg`), K9 (`rgat_src_bwd`), K7a (`wseg_t`), K6a (`segsum_t`), K15a
(`film_fwd_mask`), K15b (`masked_segsum`), K10a (`typed_dense_agg`), K10b
(`typed_dense_agg_bwd`) and K14 (`emlp1_src_bwd`): a thread per column
walking a 64-edge chunk with 2-byte loads (csrc/film_src_bwd_walk.cu,
csrc/film_bwd_walk.cu, csrc/act_agg_walk.cu, csrc/rgat_src_bwd_walk.cu,
csrc/wseg_t_walk.cu, csrc/film_fwd_mask_walk.cu,
csrc/masked_segsum_walk.cu), or, for K6a, a thread per run of 8 edges of
one head (csrc/segsum_t_walk.cu), or, for K10 and K14, typed products by
scalar f32 multiply-adds (csrc/typed_dense_agg_scalar.cu,
csrc/typed_dense_agg_bwd_scalar.cu, csrc/emlp1_src_bwd_scalar.cu),
unchanged from before their redesign; K12a's takes one stream slice a
launch. No model path calls them: chip_smoke.py and the card tests hold
the redesigned kernels to them (the same sums in the same order on every
row of at most two 64-edge chunks, K15a's mask bit for bit; K6a's: of at
most two 8-edge runs; K10's and K14's sum their products in other orders,
so each is held to the plain version instead) and time the two in turns.
Launches count under "film_src_bwd_walk", "film_bwd_walk",
"act_agg_walk", "rgat_src_bwd_walk", "wseg_t_walk", "segsum_t_walk",
"film_fwd_mask_walk", "masked_segsum_walk", "typed_dense_agg_scalar",
"typed_dense_agg_bwd_scalar" and "emlp1_src_bwd_scalar". Tensors on the
CPU take the kernels' plain versions."""

import torch

from ..ops import ranked_segment as rs


def film_src_bwd_walk(gcb_src, t_ranked, ranks, *, table_rows, act):
    """K3's function by its earlier design, from the bf16 [E, 3D]
    gamma|beta|C stream and the bf16 [table_rows, D] t table (the inputs of
    `_film_src_bwd_impl`); f32 [table_rows, D] out."""
    e = ranks.shape[0]
    dim = t_ranked.shape[1]
    if gcb_src.shape != (e, 3 * dim) or t_ranked.shape[0] != table_rows:
        raise ValueError("film_src_bwd_walk: shapes %s, %s, %s" % (
            tuple(gcb_src.shape), tuple(t_ranked.shape), tuple(ranks.shape)))
    if gcb_src.device.type == "cpu":
        return rs._film_src_bwd_plain(gcb_src, t_ranked, ranks, table_rows,
                                      act)
    for x in (gcb_src, t_ranked):
        rs._check_dtype("film_src_bwd_walk", x, torch.bfloat16)
    rs._check_ranks("film_src_bwd_walk", ranks)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=gcb_src.device)
    if e:
        rs._call("film_src_bwd_walk", (gcb_src, t_ranked, ranks, out),
                 (e, dim, rs.ACT_IDS[act]))
    return out


def film_bwd_walk(msgs, gbg_table, ranks, *, act):
    """K4's function by its earlier design, from bf16 m [E, D] and the one
    gamma|beta|g table [RPAD, 3D] (the inputs of `_film_bwd_impl`); bf16
    [E, D] d_msgs and f32 [RPAD, 2D] d_gb out."""
    e, dim = msgs.shape
    rpad = gbg_table.shape[0]
    if gbg_table.shape != (rpad, 3 * dim) or ranks.shape != (e,):
        raise ValueError("film_bwd_walk: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(gbg_table.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return rs._film_bwd_plain(msgs, gbg_table, ranks, act)
    for x in (msgs, gbg_table):
        rs._check_dtype("film_bwd_walk", x, torch.bfloat16)
    rs._check_ranks("film_bwd_walk", ranks)
    d_msgs = torch.empty((e, dim), dtype=torch.bfloat16, device=msgs.device)
    d_gb = torch.zeros((rpad, 2 * dim), dtype=torch.float32,
                       device=msgs.device)
    if e:
        rs._call("film_bwd_walk", (msgs, gbg_table, ranks, d_msgs, d_gb),
                 (e, dim, rs.ACT_IDS[act]))
    return d_msgs, d_gb


# Most heads K9's earlier body takes: its block keeps 2 x 64 x K f32
# values and 64 ranks in the 48 KB of shared memory a block gets without
# opting in.
RGAT_SRC_WALK_MAX_HEADS = 95


def act_agg_walk(msgs, ranks, *, table_rows, act, out=None):
    """K12a's function by its earlier design, on one stream slice: bf16
    msgs [E, D] and int32 ranks [E] (the inputs of `_act_agg_impl`); f32
    [table_rows, D] out, or `out` added into (its rows of these ranks
    zero)."""
    e, dim = msgs.shape
    if ranks.shape != (e,) or (out is not None
                               and out.shape != (table_rows, dim)):
        raise ValueError("act_agg_walk: shapes %s, %s" % (
            tuple(msgs.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return rs._act_agg_plain(msgs, ranks, table_rows, act, out)
    rs._check_dtype("act_agg_walk", msgs, torch.bfloat16)
    rs._check_ranks("act_agg_walk", ranks)
    if out is None:
        out = torch.zeros((table_rows, dim), dtype=torch.float32,
                          device=msgs.device)
    rs._check_dtype("act_agg_walk", out, torch.float32)
    if e:
        rs._call("act_agg_walk", (msgs, ranks, out), (e, dim, rs.ACT_IDS[act]))
    return out


def rgat_src_bwd_walk(gcb_src, t_ext, ranks, *, table_rows, num_heads, clamp):
    """K9's function by its earlier design, from the bf16 [E, D + 3K]
    stream and the bf16 [table_rows, D + K] t | lsrc table (the inputs of
    `_rgat_src_bwd_impl`); f32 [table_rows, D + K] out."""
    e, k = ranks.shape[0], num_heads
    dim = t_ext.shape[1] - k
    if (gcb_src.shape != (e, dim + 3 * k) or t_ext.shape[0] != table_rows
            or dim <= 0 or dim % k):
        raise ValueError("rgat_src_bwd_walk: shapes %s, %s, %s" % (
            tuple(gcb_src.shape), tuple(t_ext.shape), tuple(ranks.shape)))
    if gcb_src.device.type == "cpu":
        return rs._rgat_src_bwd_plain(gcb_src, t_ext, ranks, table_rows, k,
                                      clamp)
    if k > RGAT_SRC_WALK_MAX_HEADS:
        raise ValueError("rgat_src_bwd_walk: at most %d heads, got %d"
                         % (RGAT_SRC_WALK_MAX_HEADS, k))
    for x in (gcb_src, t_ext):
        rs._check_dtype("rgat_src_bwd_walk", x, torch.bfloat16)
    rs._check_ranks("rgat_src_bwd_walk", ranks)
    out = torch.zeros((table_rows, dim + k), dtype=torch.float32,
                      device=gcb_src.device)
    if e:
        rs._call("rgat_src_bwd_walk", (gcb_src, t_ext, ranks, out),
                 (e, dim, k, float(clamp)))
    return out


def wseg_t_walk(msgs, w_t, ranks, *, table_rows, num_heads, d_used=None):
    """K7a's function by its earlier design, from a bf16 stream [E, D
    (+ extra)] of which the first `d_used` (default: all) columns are
    aggregated, f32 head-major weights [K, E] and int32 ranks (the inputs
    of `_wseg_t_impl`); f32 [table_rows, D] out."""
    e, dim_in = msgs.shape
    dim = d_used or dim_in
    if (w_t.shape != (num_heads, e) or ranks.shape != (e,)
            or dim > dim_in):
        raise ValueError("wseg_t_walk: shapes %s, %s, %s, d_used %s" % (
            tuple(msgs.shape), tuple(w_t.shape), tuple(ranks.shape), d_used))
    rs._check_heads("wseg_t_walk", dim, num_heads)
    if msgs.device.type == "cpu":
        return rs._wseg_t_plain(msgs, w_t, ranks, table_rows, d_used)
    rs._check_dtype("wseg_t_walk", msgs, torch.bfloat16)
    rs._check_dtype("wseg_t_walk", w_t, torch.float32)
    rs._check_ranks("wseg_t_walk", ranks)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=msgs.device)
    if e:
        rs._call("wseg_t_walk", (msgs, w_t, ranks, out),
                 (e, dim, dim_in, num_heads))
    return out


def segsum_t_walk(msgs_t, ranks, *, table_rows):
    """K6a's function by its earlier design, from an f32 head-major stream
    [K, E] and int32 ranks (the inputs of `_segsum_t_impl`); f32
    [K, table_rows] out."""
    k, e = msgs_t.shape
    if ranks.shape != (e,):
        raise ValueError("segsum_t_walk: shapes %s, %s" % (
            tuple(msgs_t.shape), tuple(ranks.shape)))
    if msgs_t.device.type == "cpu":
        return rs._segsum_t_plain(msgs_t, ranks, table_rows)
    rs._check_dtype("segsum_t_walk", msgs_t, torch.float32)
    rs._check_ranks("segsum_t_walk", ranks)
    out = torch.zeros((k, table_rows), dtype=torch.float32,
                      device=msgs_t.device)
    if e and k:
        rs._call("segsum_t_walk", (msgs_t, ranks, out), (e, table_rows, k))
    return out


def typed_dense_agg_scalar(x, w, types, ranks, *, table_rows, act):
    """K10a's function by its earlier design (scalar f32 products), from
    the inputs of `_typed_dense_agg_impl`; f32 [table_rows, D] out."""
    e, dh = x.shape
    if (w.dim() != 3 or w.shape[1] != dh or types.shape != (e,)
            or ranks.shape != (e,)):
        raise ValueError("typed_dense_agg_scalar: shapes %s, %s, %s, %s" % (
            tuple(x.shape), tuple(w.shape), tuple(types.shape),
            tuple(ranks.shape)))
    if x.device.type == "cpu":
        return rs._typed_dense_agg_plain(x, w, types, ranks, table_rows, act)
    for t in (x, w):
        rs._check_dtype("typed_dense_agg_scalar", t, torch.bfloat16)
    rs._check_dtype("typed_dense_agg_scalar", types, torch.int32)
    rs._check_ranks("typed_dense_agg_scalar", ranks)
    out = torch.zeros((table_rows, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    if e:
        rs._call("typed_dense_agg_scalar", (x, w, types, ranks, out),
                 (e, dh, w.shape[2], w.shape[0], rs.ACT_IDS[act]))
    return out


def typed_dense_agg_bwd_scalar(x, w, g16, types, ranks, *, act):
    """K10b's function by its earlier design (scalar f32 products, dW added
    by one atomicAdd per 128-edge block, type and entry), from the inputs
    of `_typed_dense_agg_bwd_impl`; bf16 dx [E, Dh] and f32 dW [L, Dh, D]
    out. The body reads W both ways: the wrapper passes W^T too."""
    e, dh = x.shape
    if (w.dim() != 3 or w.shape[1] != dh or types.shape != (e,)
            or ranks.shape != (e,) or g16.dim() != 2
            or g16.shape[1] != w.shape[2]):
        raise ValueError("typed_dense_agg_bwd_scalar: shapes %s, %s, %s, "
                         "%s, %s" % (tuple(x.shape), tuple(w.shape),
                                     tuple(g16.shape), tuple(types.shape),
                                     tuple(ranks.shape)))
    if x.device.type == "cpu":
        return rs._typed_dense_agg_bwd_plain(x, w, g16, types, ranks, act)
    for t in (x, w, g16):
        rs._check_dtype("typed_dense_agg_bwd_scalar", t, torch.bfloat16)
    rs._check_dtype("typed_dense_agg_bwd_scalar", types, torch.int32)
    rs._check_ranks("typed_dense_agg_bwd_scalar", ranks)
    dx = torch.empty((e, dh), dtype=torch.bfloat16, device=x.device)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    if e:
        wt = w.transpose(1, 2).contiguous()
        rs._call("typed_dense_agg_bwd_scalar",
                 (x, w, wt, g16, types, ranks, dx, dw),
                 (e, dh, w.shape[2], w.shape[0], rs.ACT_IDS[act]))
    return dx, dw


def emlp1_src_bwd_scalar(gcb_src, t_ranked, type_col, w_stack, e_real, ranks,
                         *, table_rows, act):
    """K14's function by its earlier design (scalar f32 products), from the
    inputs of `_emlp1_src_bwd_impl`; f32 [table_rows, D] out. The body
    reads W both ways: the wrapper passes W^T too."""
    e = ranks.shape[0]
    dim = t_ranked.shape[1]
    if (gcb_src.shape != (e, 2 * dim) or t_ranked.shape[0] != table_rows
            or type_col.shape != (table_rows,) or w_stack.dim() != 3
            or w_stack.shape[1:] != (dim, dim) or e_real.shape != (1,)):
        raise ValueError("emlp1_src_bwd_scalar: shapes %s, %s, %s, %s, %s" % (
            tuple(gcb_src.shape), tuple(t_ranked.shape),
            tuple(type_col.shape), tuple(w_stack.shape), tuple(ranks.shape)))
    if gcb_src.device.type == "cpu":
        return rs._emlp1_src_bwd_plain(gcb_src, t_ranked, type_col, w_stack,
                                       e_real, ranks, table_rows, act)
    for t in (gcb_src, t_ranked, w_stack):
        rs._check_dtype("emlp1_src_bwd_scalar", t, torch.bfloat16)
    for t in (type_col, e_real):
        rs._check_dtype("emlp1_src_bwd_scalar", t, torch.int32)
    rs._check_ranks("emlp1_src_bwd_scalar", ranks)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=gcb_src.device)
    if e:
        wt = w_stack.transpose(1, 2).contiguous()
        rs._call("emlp1_src_bwd_scalar",
                 (gcb_src, t_ranked, type_col, w_stack, wt, e_real, ranks,
                  out), (e, dim, w_stack.shape[0], rs.ACT_IDS[act]))
    return out


def film_fwd_mask_walk(msgs, gb_table, ranks, *, act):
    """K15a's function by its earlier design, from the inputs of
    `_film_fwd_mask_impl`: f32 [RPAD, D] table and f32 [E, lanes] packed
    mask out."""
    e, dim = msgs.shape
    rpad = gb_table.shape[0]
    if gb_table.shape != (rpad, 2 * dim) or ranks.shape != (e,):
        raise ValueError("film_fwd_mask_walk: shapes %s, %s, %s" % (
            tuple(msgs.shape), tuple(gb_table.shape), tuple(ranks.shape)))
    if msgs.device.type == "cpu":
        return rs._film_fwd_mask_plain(msgs, gb_table, ranks, act)
    for t in (msgs, gb_table):
        rs._check_dtype("film_fwd_mask_walk", t, torch.bfloat16)
    rs._check_ranks("film_fwd_mask_walk", ranks)
    lanes = rs._mask_lanes(dim)
    out = torch.zeros((rpad, dim), dtype=torch.float32, device=msgs.device)
    mask = torch.empty((e, lanes), dtype=torch.float32, device=msgs.device)
    if e:
        rs._call("film_fwd_mask_walk", (msgs, gb_table, ranks, out, mask),
                 (e, dim, lanes, rs.ACT_IDS[act]))
    return out, mask


def masked_segsum_walk(mask_packed, c_e, ranks, *, table_rows, leak):
    """K15b's function by its earlier design, from the inputs of
    `_masked_segsum_impl`: f32 [table_rows, D] out, into a zeroed table
    (its chunk seams are added by atomicAdd)."""
    e, dim = c_e.shape
    if (mask_packed.dim() != 2 or mask_packed.shape[0] != e
            or mask_packed.shape[1] * rs._MASK_GROUP < dim
            or ranks.shape != (e,)):
        raise ValueError("masked_segsum_walk: shapes %s, %s, %s" % (
            tuple(mask_packed.shape), tuple(c_e.shape), tuple(ranks.shape)))
    if c_e.device.type == "cpu":
        return rs._masked_segsum_plain(mask_packed, c_e, ranks, table_rows,
                                       leak)
    rs._check_dtype("masked_segsum_walk", mask_packed, torch.float32)
    rs._check_dtype("masked_segsum_walk", c_e, torch.bfloat16)
    rs._check_ranks("masked_segsum_walk", ranks)
    out = torch.zeros((table_rows, dim), dtype=torch.float32,
                      device=c_e.device)
    if e:
        rs._call("masked_segsum_walk", (mask_packed, c_e, ranks, out),
                 (e, dim, mask_packed.shape[1], float(leak)))
    return out
