"""Row-gather variants on the card (K16; the port of
tools/rowgather_prof.py): four hand-written ways to compute
out[i] = table[idx[i]], the function behind K5b, timed beside one call of
torch.index_select (the counterpart of the JAX tool's `xla_take`).

  loop     one warp per output row, one element a lane a step
  loop8    the same, 8 rows' loads in flight per warp
  take     16-byte loads and stores, indices clamped to [0, rows)
  onehot   a 256-edge block stages its window of `win` table rows in
           shared memory; rows rounded to bf16, zero outside the window

(csrc/rowgather.cu; each design is described there.) loop, loop8 and take
copy exactly; loop and loop8 need indices in [0, rows), as their TPU
kernels do. onehot is the JAX tool's windowed one-hot function, zero rows
included: on its windowed stream, whose indices are not sorted within a
block, every edge whose index falls below its block's start gets a zero
row. Every wrapper takes its plain version only for tensors on the CPU,
and raises for an E that is not a multiple of 2,048 (the JAX tool's grid
leaves such a tail unwritten).

Usage: python -m tf_gnn_samples_torch.tools.rowgather_prof [E] [D] [ROWS] [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from ..ops import ranked_segment as rs
from ..runtime.model import resolve_device
from . import timing

STEP = 2048
ONEHOT_EDGES = 256
# Variant ids of csrc/rowgather.cu.
_VARIANT_IDS = {"loop": 0, "loop8": 1, "take": 2, "onehot": 3}
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _loop_plain(table, idx):
    return table.index_select(0, idx)


def _take_plain(table, idx):
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def _onehot_plain(table, idx, starts, win):
    local = idx - starts.repeat_interleave(ONEHOT_EDGES)
    inside = (local >= 0) & (local < win)
    rows = _take_plain(table, idx).to(torch.bfloat16).to(table.dtype)
    return torch.where(inside[:, None], rows, torch.zeros_like(rows))


def _gather(variant, table, idx, starts=None, win=0):
    e = idx.shape[0]
    name = "rowgather_" + variant
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError("%s: shapes %s, %s" % (name, tuple(table.shape),
                                                tuple(idx.shape)))
    if e % STEP:
        raise ValueError("%s: E = %d is not a multiple of %d" % (name, e,
                                                                 STEP))
    if variant == "onehot" and starts.shape != (e // ONEHOT_EDGES,):
        raise ValueError("%s: starts %s for E = %d" % (
            name, tuple(starts.shape), e))
    if table.device.type == "cpu":
        if variant == "onehot":
            return _onehot_plain(table, idx, starts, win)
        return (_take_plain if variant == "take" else _loop_plain)(table, idx)
    if table.dtype not in _ELEM_BYTES:
        raise TypeError("%s: expected bfloat16 or float32, got %s"
                        % (name, table.dtype))
    for x in (idx, starts if starts is not None else idx):
        if x.dtype != torch.int32:
            raise TypeError("%s: indices must be int32, got %s"
                            % (name, x.dtype))
    rows, dim = table.shape
    out = torch.empty((e, dim), dtype=table.dtype, device=table.device)
    # Only onehot reads `starts`; the others get the index stream there.
    rs._call("rowgather", (table, idx, idx if starts is None else starts,
                           out),
             (e, dim, rows, _ELEM_BYTES[table.dtype], _VARIANT_IDS[variant],
              win), counter=name)
    return out


def kernel_loop(table, idx):
    """out[i] = table[idx[i]] ([E, D], the table's type, bf16 or f32),
    exact; idx int32 [E] in [0, rows)."""
    return _gather("loop", table, idx)


def kernel_loop8(table, idx):
    """kernel_loop's function, 8 rows a warp; idx in [0, rows)."""
    return _gather("loop8", table, idx)


def kernel_take(table, idx):
    """out[i] = table[clip(idx[i], 0, rows - 1)], exact."""
    return _gather("take", table, idx)


def kernel_onehot(table, idx, starts, win=32):
    """out[i] = bf16(table[idx[i]]) in the table's type where
    0 <= idx[i] - starts[i // 256] < win, else 0; idx in [0, rows),
    starts int32 [E / 256]."""
    return _gather("onehot", table, idx, starts, win)


def block_starts(idx):
    """The JAX tool's one-hot window starts: each 256-edge block's first
    index with its low 3 bits cleared."""
    return (idx.reshape(-1, ONEHOT_EDGES)[:, 0] & ~7).astype(np.int32)


def make_inputs(rng, e, d, rows):
    """One table type's inputs, drawn from `rng` in the order of
    tools/rowgather_prof.py main: the f64 standard-normal table [rows, D],
    a uniform int32 index stream [E], and the windowed stream with its
    block starts. The JAX tool also draws a sorted stream that it never
    uses; it is drawn here too, so one seed gives both tools the same
    streams."""
    table = rng.standard_normal((rows, d))
    idx = rng.integers(0, rows, size=e).astype(np.int32)
    rng.integers(0, rows, size=e)  # the JAX tool's unused `idx_s`
    span = np.repeat(np.arange(e // ONEHOT_EDGES) * 12, ONEHOT_EDGES)
    idx_w = (span + rng.integers(0, 12, size=e)).astype(np.int32)
    return table, idx, idx_w, block_starts(idx_w)


def gather_bytes(table, idx, out_rows):
    """Bytes a gather must move: each used table row once, the indices,
    `out_rows` output rows."""
    row_bytes = table.shape[1] * table.element_size()
    used = int(torch.unique(idx).numel())
    return used * row_bytes + idx.numel() * 4 + out_rows * row_bytes


def zero_share(out):
    """The share of all-zero rows of a gathered [E, D] stream."""
    return float((out == 0).all(dim=1).float().mean())


def run(e, d, rows, *, device, dtypes=("bf16", "f32"), log=print):
    """The JAX tool's measurement (seed 0, window 32) for each table type
    of `dtypes`: loop,
    loop8 and take on the uniform stream, onehot on the windowed stream,
    and take on the windowed stream as onehot's yardstick, each on the card
    timed (ms, queued ms, M rows/s) beside torch.index_select on the same
    stream (single call and queued), its plain version and its byte
    bound. Inputs are drawn for both
    table types in the JAX tool's order whatever `dtypes` holds. Returns a
    dict per (type, variant, stream): its launches in this run, onehot's
    share of zero rows and "call" = (fn, plain, args) for a caller's own
    checks."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    win = 32
    on_card = device.type == "cuda"
    results = []
    for dname, dtype in DTYPES.items():
        table_np, idx_np, idxw_np, starts_np = make_inputs(rng, e, d, rows)
        if dname not in dtypes:
            continue
        table = torch.from_numpy(table_np).to(device=device,
                                              dtype=torch.float32).to(dtype)
        idx, idx_w, starts = (torch.from_numpy(x).to(device)
                              for x in (idx_np, idxw_np, starts_np))
        local = idx_w - starts.repeat_interleave(ONEHOT_EDGES)
        inside = (local >= 0) & (local < win)
        log("--- dtype=%s E=%d D=%d rows=%d (%s) ---" % (dname, e, d, rows,
                                                        device))
        cases = (
            ("loop", kernel_loop, _loop_plain, (table, idx), "uniform",
             gather_bytes(table, idx, e)),
            ("loop8", kernel_loop8, _loop_plain, (table, idx), "uniform",
             gather_bytes(table, idx, e)),
            ("take", kernel_take, _take_plain, (table, idx), "uniform",
             gather_bytes(table, idx, e)),
            ("onehot", kernel_onehot, _onehot_plain,
             (table, idx_w, starts, win), "windowed",
             gather_bytes(table, idx_w[inside], e) + starts.numel() * 4),
            ("take", kernel_take, _take_plain, (table, idx_w), "windowed",
             gather_bytes(table, idx_w, e)),
        )
        library = {}
        if on_card:
            for stream, ix in (("uniform", idx), ("windowed", idx_w)):
                select = lambda ix=ix: table.index_select(0, ix)
                library[stream] = (timing.cuda_ms(select),
                                   timing.cuda_queued_ms(select))
                log("%-24s %8.4f ms  %8.1f M rows/s  (%.4f queued; %s "
                    "stream)" % ("torch.index_select", library[stream][0],
                                 e / library[stream][0] / 1e3,
                                 library[stream][1], stream))
        for name, fn, plain, args, stream, nbytes in cases:
            counter = "rowgather_" + name
            before = rs.LAUNCHES[counter]
            row = dict(name=name, kernel=counter, dtype=dname, stream=stream,
                       e=e, d=d, rows=rows, nbytes=nbytes,
                       bound_ms=timing.bound_ms(nbytes, 0),
                       call=(fn, plain, args))
            label = "kernel_%s (%s)" % (name, stream)
            if name == "onehot":
                row["zero_share"] = zero_share(fn(*args))
                log("%s: %.1f %% of the output rows are zero (indices below "
                    "their block's start)" % (label, 100 * row["zero_share"]))
            if on_card:
                row.update(ms=timing.cuda_ms(lambda: fn(*args)),
                           queued_ms=timing.cuda_queued_ms(lambda: fn(*args)),
                           plain_ms=timing.cuda_ms(lambda: plain(*args)),
                           library_ms=library[stream][0],
                           library_queued_ms=library[stream][1])
                log("%-24s %8.4f ms  %8.1f M rows/s  (%.4f queued, %.2fx "
                    "the bound %.4f ms; plain %.4f ms)"
                    % (label, row["ms"], e / row["ms"] / 1e3,
                       row["queued_ms"], row["queued_ms"] / row["bound_ms"],
                       row["bound_ms"], row["plain_ms"]))
            else:
                if name != "onehot":
                    fn(*args)
                log("%-24s ran on %s (times need the card)" % (label, device))
            row["launches"] = rs.LAUNCHES[counter] - before
            results.append(row)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the K16 row-gather variants against "
                    "torch.index_select.")
    parser.add_argument("E", nargs="?", type=int, default=16 * STEP,
                        help="gathered rows, a multiple of 2048 "
                             "(default 32768)")
    parser.add_argument("D", nargs="?", type=int, default=320,
                        help="columns (default 320)")
    parser.add_argument("ROWS", nargs="?", type=int, default=8192,
                        help="table rows (default 8192)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(timing.card_name(device))
    run(args.E, args.D, args.ROWS, device=device)


if __name__ == "__main__":
    main()
