"""Kernel timing on the card with CUDA events (chip_smoke.py and the
harnesses of this package time with these), and the card's peak rates
that bounds are counted with."""

import statistics

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense


def card_name(device) -> str:
    return "device %s, torch %s, CUDA %s" % (
        torch.cuda.get_device_name(device), torch.__version__,
        torch.version.cuda)


def bound_ms(nbytes: int, nops: int) -> float:
    """The least time the card could take: bytes at the memory rate
    against f32 operations at the f32 rate, the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS) * 1e3


def cuda_ms(fn, warmup=3, iters=20) -> float:
    """Median over `iters` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_queued_ms(fn, iters=20) -> float:
    """Device time of one call when the card never waits for the host: a
    spin kernel keeps the card busy while the host enqueues `iters` calls
    behind it, and CUDA events bracket those calls. `cuda_ms` times one
    call at a time on an idle card, so it also holds the tens of
    microseconds the host takes between the call's first and last launch;
    the difference of the two is that host share."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # torch.cuda._sleep is private to PyTorch and spins for a number of
    # clock cycles: 40 million are about 20 ms at a clock near 2 GHz. The
    # result does not depend on that time, only on its outlasting the
    # host's enqueueing of `iters` calls.
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
