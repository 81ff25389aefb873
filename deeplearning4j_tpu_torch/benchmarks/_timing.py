"""Timing for the kernel experiments.

The JAX experiments time a jitted program that scans n calls and forces a
host read, best of ``reps``: no host time between the calls. Here: one
warm call, then the n calls captured once in a CUDA graph, and CUDA
events around each of ``reps`` replays of it, the end event synchronised
before the clock is read; best of ``reps`` means per call. A replay
launches the captured kernels back to back, so the Python wrapper's
checks and allocations stay out of the window. On the CPU (``--device
cpu``, the tests' smoke runs) the host clock times the calls themselves;
such a time is the CPU's and is labelled so in each result (`timer`).
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional

import torch

# NVIDIA H100 SXM data sheet: the memory rate every byte bound divides by
DATASHEET_BYTES_PER_S = 3.35e12


def time_ms(fn: Callable[[], object], device: torch.device, n: int,
            reps: int) -> float:
    """Best over ``reps`` of the mean milliseconds per call of ``n``
    back-to-back calls of ``fn``, after one warm call: on the card, the
    replays of one CUDA graph that holds the n calls."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / n)
        del graph
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / n)
    return best


def timer_name(device: torch.device) -> str:
    return ("cuda events around CUDA-graph replays" if device.type == "cuda"
            else "host perf_counter")


def card(device: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them (every
    time is kept beside them), or None off the card."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else torch.cuda.get_device_name(device)
