"""What the kernel-timing tools of this folder share: the card's name and
power limit, and a CUDA-event median."""

from __future__ import annotations

import statistics
import subprocess

import torch


def require_card(tool: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them; exits
    where there is no CUDA device, since the kernels run only on the card."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; the kernels run only on the card")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event times of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
