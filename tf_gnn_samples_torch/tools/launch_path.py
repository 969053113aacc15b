"""K6b's single call split into the host's time and the card's, step by
step along its launch path, through `ops/ranked_segment.py`'s `_run` and
through the earlier launch path (`earlier_designs.run_with_device_context`,
which looked the entry point up, switched the device and built a
torch.cuda.Stream on every call), beside `torch.index_select(1, ...)` on
the same inputs.

Each host time is `timing.cuda_host_ms`: calls enqueued behind a busy
card, wall time over their count. A step's share is a step timed alone or
the difference of two nested calls' host times. The wrapper
(`_expand_t_impl`) is its argument checks, `Tensor.new_empty`, the layout
check and pointers of its inputs (`_laid_out_ptrs`) and `_run`; `_run` on
ready arguments less the bare entry point is the entry lookup, the device
and stream and the count; the bare entry point is ctypes and the launch
itself. Through the earlier path: the wrapper less `_call` on a ready
output is its checks and `torch.empty`; `_call` less `_run` the layout
check and the pointers of all three tensors. Single calls
(`timing.cuda_ms`) and the card's time (`timing.cuda_queued_ms`) are
taken in turns: earlier path, new path, new path, earlier path.

    python -m tf_gnn_samples_torch.tools.launch_path [--edges E] \\
        [--rows R] [--heads K]

(defaults: the tuned QM9 batch's fine ranks, 161,792 edges over 162,056
rows, and RGAT's 8 heads; random ranks, sorted). Needs a CUDA device.
"""

import argparse
import collections
import json
import statistics

import torch

from ..ops import cuda_build
from ..ops import ranked_segment as rs
from . import earlier_designs
from .timing import card_name, cuda_host_ms, cuda_ms, cuda_queued_ms


def _steps(table_t, ranks):
    """{label: fn}: K6b's wrapper through each path and the nested calls
    whose host times split it, and index_select."""
    k, rows = table_t.shape
    e = ranks.shape[0]
    dev = table_t.device
    out = torch.empty((k, e), dtype=torch.float32, device=dev)
    ints = (e, rows, k)
    args = (table_t.data_ptr(), ranks.data_ptr(), out.data_ptr(), *ints)
    fn = rs._entry("expand_t")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ed = earlier_designs
    return {
        "new: wrapper": lambda: rs._expand_t_impl(table_t, ranks),
        "new: _laid_out_ptrs": lambda: rs._laid_out_ptrs(
            "expand_t", (table_t, ranks), dev.index),
        "new: Tensor.new_empty": lambda: table_t.new_empty((k, e)),
        "new: _run": lambda: rs._run("expand_t", dev.index, args),
        "entry point": lambda: fn(*args, stream),
        "earlier: wrapper": lambda: ed.expand_t_earlier_path(table_t, ranks),
        "earlier: _call": lambda: ed.call_with_device_context(
            "expand_t", (table_t, ranks, out), ints),
        "earlier: _run": lambda: ed.run_with_device_context("expand_t", dev,
                                                            args),
        "torch.empty": lambda: torch.empty((k, e), dtype=torch.float32,
                                           device=dev),
        "index_select": lambda: table_t.index_select(1, ranks),
    }


def measure(table_t, ranks, rounds=2):
    """K6b through both launch paths and index_select(1, ...) on the same
    inputs: single-call ms, queued ms (the card's) and host ms of each,
    means over `rounds` turns (earlier, new, new, earlier; index_select
    last each round), the host's ms of each step of both paths, and the
    single-call ms of nothing (what the two CUDA events of a single call
    take themselves).
    Checks first that both paths give index_select's values rounded as
    K6b rounds them, bit for bit."""
    want = rs._expand_t_plain(table_t, ranks)
    for got in (rs._expand_t_impl(table_t, ranks),
                earlier_designs.expand_t_earlier_path(table_t, ranks)):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("expand_t disagrees with its plain version")
    steps = _steps(table_t, ranks)
    calls = {"new": steps["new: wrapper"],
             "earlier": steps["earlier: wrapper"],
             "index_select": steps["index_select"]}
    taken = collections.defaultdict(list)
    order = ["earlier", "new", "new", "earlier", "index_select"]
    for _ in range(rounds):
        for which in order:
            fn = calls[which]
            taken[which + "_ms"].append(cuda_ms(fn))
            taken[which + "_queued_ms"].append(cuda_queued_ms(fn))
            taken[which + "_host_ms"].append(cuda_host_ms(fn))
        for label, fn in steps.items():
            taken["host_ms " + label].append(cuda_host_ms(fn))
    got = {k: statistics.mean(v) for k, v in taken.items()}
    # The event pair's own time: a single call of nothing.
    got["event_pair_ms"] = cuda_ms(lambda: None)
    host = {label: got.pop("host_ms " + label) for label in steps}
    launch = host["entry point"]
    new_run, old_run = host["new: _run"], host["earlier: _run"]
    parts = {
        "new": {
            "checks": (host["new: wrapper"] - new_run
                       - host["new: Tensor.new_empty"]
                       - host["new: _laid_out_ptrs"]),
            "Tensor.new_empty": host["new: Tensor.new_empty"],
            "layout checks and pointers": host["new: _laid_out_ptrs"],
            "entry lookup, device, stream, count": new_run - launch,
            "ctypes and the launch": launch},
        "earlier": {
            "checks and torch.empty": (host["earlier: wrapper"]
                                       - host["earlier: _call"]),
            "of them torch.empty": host["torch.empty"],
            "layout checks and pointers": host["earlier: _call"] - old_run,
            "entry lookup, device, stream, count": old_run - launch,
            "ctypes and the launch": launch}}
    got["host_steps_ms"] = host
    got["host_parts_ms"] = parts
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--edges", type=int, default=161792)
    p.add_argument("--rows", type=int, default=162056)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("launch_path: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(a.seed)
    table_t = torch.randn((a.heads, a.rows), generator=gen, device=dev)
    ranks = torch.sort(torch.randint(0, a.rows, (a.edges,), generator=gen,
                                     device=dev)).values.to(torch.int32)
    cuda_build.build_all(["expand_t"])
    print(card_name(dev))
    print(json.dumps(measure(table_t, ranks)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
