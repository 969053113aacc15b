"""A/B harness for the FiLM kernel variants on the card (K16; the port of
tools/film_fwd_ab.py).

The variants compute the functions of the shipped FiLM kernels K1
(`film_fwd`: table[r] = sum bf16(act(gamma[r] * m_e + beta[r]))) and K2
(`film_bwd_dgb`: its d_gamma | d_beta) with other designs
(csrc/film_fwd_ab.cu, csrc/film_dgb_ab.cu; each source says which TPU
variant it answers and how):

* forward v3, group G: K1's earlier design (csrc/film_walk.cuh, a thread
  per column walking its block's edges) over 64 * G edges a block; at
  G = 1 that design itself, the baseline of K1's redesign;
* forward v2a "scratch": a block's rank window summed in shared memory
  and written once;
* forward v2b "stepdot": bf16 terms staged in shared memory with 16-byte
  loads, then a column-parallel segmented sum;
* d_gamma | d_beta v3, group G: K2's earlier design over 64 * G edges a
  block (G = 1: that design itself);
* d_gamma | d_beta v4, group G: the same with the two halves summed by
  two thread groups.

The harness checks each variant against K1 or K2 on the same inputs, then
times it with CUDA events, as a single call and queued behind a busy
card, beside K1 or K2, the plain version and the byte bound. Every wrapper
takes its plain version (ops/ranked_segment.py `_film_fwd_plain`,
`_film_bwd_dgb_plain`) only for tensors on the CPU, and raises for an E
that is not a multiple of 2,048 (the JAX tool's grid leaves such a tail
unwritten). The JAX kernels drop the edges of a block whose ranks leave
its window; these kernels have no window and take any group in 1, 2, 4, 8.

Usage: python -m tf_gnn_samples_torch.tools.film_fwd_ab [E] [D] [--device cuda|cpu]
"""

import argparse
import functools

import numpy as np
import torch

from ..ops import ranked_segment as rs
from ..runtime.model import resolve_device
from . import timing

STEP = rs.STEP
GROUPS = (1, 2, 4, 8)
# Variant ids of csrc/film_fwd_ab.cu and csrc/film_dgb_ab.cu.
_FWD_IDS = {"v3": 0, "v2a": 1, "v2b": 2}
_DGB_IDS = {"v3": 0, "v4": 1}


def _check_shapes(name, msgs, table, ranks, width, group):
    e, dim = msgs.shape
    if e % STEP:
        raise ValueError("%s: E = %d is not a multiple of %d" % (name, e,
                                                                 STEP))
    if (table.dim() != 2 or table.shape[1] != width * dim
            or ranks.shape != (e,)):
        raise ValueError("%s: shapes %s, %s, %s" % (
            name, tuple(msgs.shape), tuple(table.shape), tuple(ranks.shape)))
    if group not in GROUPS:
        raise ValueError("%s: group %r not in %s" % (name, group, GROUPS))


def _launch(source, counter, variant_id, msgs, table, ranks, out_width, act,
            group):
    """Launch variant `variant_id` of csrc/<source>.cu into a zeroed f32
    [rows, out_width * D] table, counted under `counter`."""
    for x in (msgs, table):
        rs._check_dtype(counter, x, torch.bfloat16)
    rs._check_ranks(counter, ranks)
    e, dim = msgs.shape
    out = torch.zeros((table.shape[0], out_width * dim), dtype=torch.float32,
                      device=msgs.device)
    if e:
        rs._call(source, (msgs, table, ranks, out),
                 (e, dim, rs.ACT_IDS[act], variant_id, group),
                 counter=counter)
    return out


def _fwd(variant, msgs, gb_table, ranks, act, group=1):
    _check_shapes("film_fwd_" + variant, msgs, gb_table, ranks, 2, group)
    if msgs.device.type == "cpu":
        return rs._film_fwd_plain(msgs, gb_table, ranks, act)
    return _launch("film_fwd_ab", "film_fwd_" + variant, _FWD_IDS[variant],
                   msgs, gb_table, ranks, 1, act, group)


def _dgb(variant, msgs, gbg_table, ranks, act, group):
    _check_shapes("film_dgb_" + variant, msgs, gbg_table, ranks, 3, group)
    if msgs.device.type == "cpu":
        return rs._film_bwd_dgb_plain(msgs, gbg_table, ranks, act)
    return _launch("film_dgb_ab", "film_dgb_" + variant, _DGB_IDS[variant],
                   msgs, gbg_table, ranks, 2, act, group)


def _impl(variant, msgs, gb_table, ranks, *, act):
    """K1's function by variant "a" (v2a, "scratch") or "b" (v2b,
    "stepdot", D a multiple of 8): bf16 m [E, D], gamma|beta [RPAD, 2D],
    int32 nondecreasing ranks [E] (gaps allowed, as K1 allows them); f32
    [RPAD, D] out."""
    if variant not in ("a", "b"):
        raise ValueError("variant %r is not 'a' or 'b'" % (variant,))
    if variant == "b" and msgs.shape[1] % 8:
        raise ValueError("film_fwd_v2b: D = %d is not a multiple of 8"
                         % msgs.shape[1])
    return _fwd("v2" + variant, msgs, gb_table, ranks, act)


def _impl_v3(msgs, gb_table, ranks, *, act, group):
    """K1's function by v3: K1's earlier walk over 64 * group edges a
    block."""
    return _fwd("v3", msgs, gb_table, ranks, act, group)


def _impl_dgb_v3(msgs, gbg_table, ranks, *, act, group):
    """K2's function (f32 [RPAD, 2D] d_gamma | d_beta from bf16 m [E, D]
    and gamma|beta|g [RPAD, 3D]) by v3: K2's earlier walk over 64 * group
    edges a block, one thread per column for both halves."""
    return _dgb("v3", msgs, gbg_table, ranks, act, group)


def _impl_dgb_v4(msgs, gbg_table, ranks, *, act, group):
    """K2's function by v4: as v3, with the d_gamma and d_beta halves
    summed by two thread groups that each recompute dz."""
    return _dgb("v4", msgs, gbg_table, ranks, act, group)


def fwd_variants(act="relu"):
    """(name, launch counter, fn(m, gb, ranks)) of the forward variants
    the JAX tool times, and v3 at group 1 (K1's earlier design)."""
    out = [("v2a", "film_fwd_v2a", functools.partial(_impl, "a", act=act)),
           ("v2b", "film_fwd_v2b", functools.partial(_impl, "b", act=act))]
    for group in GROUPS:
        out.append(("v3 g=%d" % group, "film_fwd_v3",
                    functools.partial(_impl_v3, act=act, group=group)))
    return out


def dgb_variants(act="relu"):
    """(name, launch counter, fn(m, gbg, ranks)) of the d_gamma | d_beta
    variants the JAX tool times, and v3 at group 1 (K2's earlier
    design)."""
    return ([("v3 g=%d" % g, "film_dgb_v3",
              functools.partial(_impl_dgb_v3, act=act, group=g))
             for g in GROUPS]
            + [("v4 g=%d" % g, "film_dgb_v4",
                functools.partial(_impl_dgb_v4, act=act, group=g))
               for g in (2, 4)])


def make_stream(e, n_groups, seed=0):
    """tools/film_fwd_ab.py `make_stream` (numpy only, so one seed gives
    both tools the same ranks): E nondecreasing gap-free int32 ranks over
    n_groups groups of multinomial sizes, each at least 1."""
    rng = np.random.RandomState(seed)
    sizes = rng.multinomial(e - n_groups, np.ones(n_groups) / n_groups) + 1
    return np.repeat(np.arange(n_groups, dtype=np.int32), sizes)


def make_inputs(e, d, rows):
    """Standard-normal f32 message stream [E, D] and gamma|beta [rows, 2D]
    and gamma|beta|g [rows, 3D] tables, made with numpy from seed 0 (the
    caller rounds them to bf16)."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((e, d), dtype=np.float32),
            rng.standard_normal((rows, 2 * d), dtype=np.float32),
            rng.standard_normal((rows, 3 * d), dtype=np.float32))


def fwd_bytes(e, d, n_groups, rows):
    """Bytes K1's function must move: the bf16 stream and the ranks, the
    used gamma|beta rows, the f32 output table."""
    return e * d * 2 + e * 4 + n_groups * 2 * d * 2 + rows * d * 4


def dgb_bytes(e, d, n_groups, rows):
    """Bytes K2's function must move: the bf16 stream and the ranks, the
    used gamma|beta|g rows, the f32 [rows, 2D] output."""
    return e * d * 2 + e * 4 + n_groups * 3 * d * 2 + rows * 2 * d * 4


def run(e, d, *, device, ranks=None, rows=None, log=print):
    """Each variant against the shipped K1 / K2 on one stream, then (on the
    card) its times, with relu as the JAX tool times them. `ranks` (int32
    [E], nondecreasing, gap-free) default to make_stream(E, E // 16) and
    `rows` to the JAX tool's table height. Returns {"fwd": [...], "dgb":
    [...]}, a dict per variant: its name, launch counter, max relative
    error against K1 / K2, the launches it made in this run, its byte
    bound and, on the card, its ms and queued ms beside K1's / K2's and
    the plain version's ms; "call" holds (fn, plain, args) for a caller's
    own checks."""
    device = torch.device(device)
    act = "relu"
    if ranks is None:
        ranks = make_stream(e, e // 16)
    ranks = torch.as_tensor(ranks, device=device).to(torch.int32)
    n_groups = int(ranks[-1]) + 1
    rows = rows or rs.rank_table_rows(n_groups + 1, 256)
    m, gb, gbg = (torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)
                  for x in make_inputs(e, d, rows))
    on_card = device.type == "cuda"
    log("E=%d D=%d: %d rank groups, table rows %d, act %s, %s"
        % (e, d, n_groups, rows, act, device))
    halves = (
        ("fwd", "K1 film_fwd", gb, fwd_variants(act),
         functools.partial(rs._film_fwd_impl, act=act),
         functools.partial(rs._film_fwd_plain, act=act),
         fwd_bytes(e, d, n_groups, rows), 4 * e * d),
        ("dgb", "K2 film_bwd_dgb", gbg, dgb_variants(act),
         functools.partial(rs._film_bwd_dgb_impl, act=act),
         functools.partial(rs._film_bwd_dgb_plain, act=act),
         dgb_bytes(e, d, n_groups, rows), 7 * e * d),
    )
    results = {}
    for half, base_name, table, variants, base, plain, nbytes, nops in halves:
        args = (m, table, ranks)
        bound = timing.bound_ms(nbytes, nops)
        ref = base(*args)
        scale = float(ref.abs().max()) + 1e-9
        rows_out = []
        # Correctness first.
        for name, counter, fn in variants:
            before = rs.LAUNCHES[counter]
            err = float((fn(*args) - ref).abs().max()) / scale
            log("%s %s max rel err vs %s: %.2e" % (half, name, base_name,
                                                     err))
            rows_out.append(dict(
                name=name, kernel=counter, max_rel_err=err,
                launches=rs.LAUNCHES[counter] - before, nbytes=nbytes,
                nops=nops, bound_ms=bound,
                call=(fn, plain, args)))
        results[half] = rows_out
        if not on_card:
            log("%s: times need the card (device %s)" % (half, device))
            continue
        base_ms = timing.cuda_ms(lambda: base(*args))
        base_queued = timing.cuda_queued_ms(lambda: base(*args))
        plain_ms = timing.cuda_ms(lambda: plain(*args))
        log("%s %s: %.4f ms (%.4f queued); plain %.4f ms; bound %.4f ms "
            "(%d bytes at 3.35 TB/s)" % (half, base_name, base_ms,
                                         base_queued, plain_ms, bound,
                                         nbytes))
        for row, (name, counter, fn) in zip(rows_out, variants):
            before = rs.LAUNCHES[counter]
            row.update(ms=timing.cuda_ms(lambda: fn(*args)),
                       queued_ms=timing.cuda_queued_ms(lambda: fn(*args)),
                       base_ms=base_ms, base_queued_ms=base_queued,
                       plain_ms=plain_ms)
            row["launches"] += rs.LAUNCHES[counter] - before
            log("%s %-8s %.4f ms (%.4f queued, %.2fx the bound), %s %.4f "
                "(%.4f queued)" % (half, name, row["ms"], row["queued_ms"],
                                   row["queued_ms"] / bound, base_name,
                                   base_ms, base_queued))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the K16 FiLM kernel variants against K1 and K2.")
    parser.add_argument("E", nargs="?", type=int, default=301056,
                        help="edges, a multiple of 2048 (default 301056)")
    parser.add_argument("D", nargs="?", type=int, default=320,
                        help="columns (default 320)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(timing.card_name(device))
    run(args.E, args.D, device=device)


if __name__ == "__main__":
    main()
