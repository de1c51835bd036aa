"""What the tools of this folder share: the card's name and power limit (the
one ``nvidia-smi`` reader), a CUDA-event median, and the refusal of a card
that is not there."""

from __future__ import annotations

import statistics
import subprocess

import torch


def smi_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the first card)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def require_device(device: str, tool: str) -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` without a card raises,
    since a tool never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool} --device {device}: no CUDA device here; pass "
                           f"--device cpu to run on the CPU")
    return dev


def card_and_power(device) -> tuple:
    """(the card's name, its power limit in W); ("cpu", None) on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu", None
    name, power = (part.strip() for part in smi_name_and_power().rsplit(",", 1))
    return name, float(power.split()[0])


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
