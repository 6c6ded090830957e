"""Device resolution for the port's entry points.

`None` means the card: the entry points run on CUDA unless the caller asks
for the CPU by name. There is no silent fallback — a request for CUDA on a
machine without it raises.
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device=None) -> torch.device:
    """None -> cuda (raising when CUDA is absent); anything else is taken
    as an explicit request and checked the same way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def wide_product_rate() -> float:
    """32x32->64 integer products per second the card can issue: the CUDA
    C++ Programming Guide's throughput table gives 64 32-bit integer
    multiply-adds per SM per clock on compute capability 9.0, and a 64-bit
    product is two of them (its low and high halves); times the SMs and
    the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 / 2 * max_sm_clock_hz()


def int_op_rate() -> float:
    """32-bit integer instructions per second the card can issue (adds,
    logic ops, shifts): the same table's 64 per SM per clock on compute
    capability 9.0, times the SMs and the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * max_sm_clock_hz()


def time_ms(fn, reps: int) -> float:
    """Device time of one call of `fn`, in ms: CUDA events around `reps`
    calls after one warm-up call, over `reps`."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
