"""The earlier designs of K3 (`film_src_bwd`) and K4 (`film_bwd`): a
thread per column walking a 64-edge chunk with 2-byte loads
(csrc/film_src_bwd_walk.cu, csrc/film_bwd_walk.cu, unchanged from before
their redesign in csrc/film_rows.cuh). No model path calls them:
chip_smoke.py and the card tests hold the redesigned kernels to them (the
same sums in the same order on every row of at most two 64-edge chunks)
and time the two in turns. Launches count under "film_src_bwd_walk" and
"film_bwd_walk". Tensors on the CPU take the kernels' plain versions."""

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
