"""From a `torch.profiler` trace to what the per-layer readers and the result line read.

On the card the profiler records CUDA activity alone (kernels, copies, and the CUDA API
calls of the host): recording every host operator as well slowed the training step of
`b2_train_b4` by 27% on an H100 (0.419 s untraced, 0.534 s), against 12% (0.469 s). The
traced window runs from the start of the marker kernels launched first to the end of those
launched last (`MARK`, `torch.cuda._sleep`, `MARKS` at each end): the device is idle when
the first is launched, and the last runs after all the window's work, in the trace's own
clock; where the trace lost the markers, it is the span of the device operations it did
record. On the CPU (the tests) the window is the span of the `WINDOW` annotation. Device time is the union of the
intervals in which an operation (a kernel, a copy or a fill) ran on the device, so kernels
that overlap count once. Launches are the CUDA API calls that launch a kernel
(`LAUNCH_CALLS`, as torch.profiler names them), less the markers' inside the window.

The trace is read from the profiler's raw events, without building its tree of function
events, which costs minutes at a million events.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW = "benchmark_window"
MARK = "spin_kernel"  # the kernel of torch.cuda._sleep, which marks the window's ends
MARKS = 3  # markers launched at each end
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
TOP = 10


@dataclass
class Trace:
    """Device operations in the window, sorted by start: names, starts and ends (ns, the
    trace's clock); the window; launches; host events for naming idle gaps."""
    names: List[str]
    starts: np.ndarray
    ends: np.ndarray
    window: Tuple[int, int]
    launches: int
    host_names: List[str]
    host_starts: np.ndarray
    host_ends: np.ndarray

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> np.ndarray:
        """The union of the device operations' intervals, clipped to the window: (n, 2)."""
        return union(self.starts, self.ends, *self.window)

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9 if len(iv) else 0.0

    def kernel_seconds(self, match) -> float:
        """Seconds of the device operations whose name `match(name)` accepts (summed, each
        clipped to the window)."""
        lo, hi = self.window
        total = 0
        for n, s, e in zip(self.names, self.starts, self.ends):
            if match(n):
                total += max(0, min(e, hi) - max(s, lo))
        return total * 1e-9

    def k1_seconds(self) -> float:
        """Device seconds of K1 in the window: each `uttk::k1::attn_kernel`, the
        `uttk::ln_kernel` launched just before it and the `uttk::gemm_kernel` (the
        out-projection) launched just after it, in stream order."""
        names, (lo, hi) = self.names, self.window
        total = 0
        for i, n in enumerate(names):
            if "uttk" not in n or "attn_kernel" not in n:
                continue
            picked = [i]
            if i > 0 and "uttk" in names[i - 1] and "ln_kernel" in names[i - 1]:
                picked.append(i - 1)
            if i + 1 < len(names) and "uttk" in names[i + 1] and "gemm_kernel" in names[i + 1]:
                picked.append(i + 1)
            for j in picked:
                total += max(0, min(int(self.ends[j]), hi) - max(int(self.starts[j]), lo))
        return total * 1e-9

    def device_ops(self, top: int = TOP) -> List[List]:
        """[[name, seconds], ...] of the operations that took most device time."""
        by: Dict[str, int] = {}
        for n, s, e in zip(self.names, self.starts, self.ends):
            by[n] = by.get(n, 0) + int(e - s)
        best = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[short(n), v * 1e-9] for n, v in best]

    def idle_gaps(self, top: int = TOP) -> List[List]:
        """[[what the host ran, seconds], ...] of the longest gaps in the device's work, each
        named by the innermost host event that covers the gap's middle."""
        iv = self.busy_intervals()
        lo, hi = self.window
        edges = np.concatenate([[lo], iv.reshape(-1), [hi]]).reshape(-1, 2)
        gaps = edges[:, 1] - edges[:, 0]
        order = np.argsort(-gaps)[:top]
        out = []
        for i in order:
            if gaps[i] <= 0:
                break
            mid = (edges[i, 0] + edges[i, 1]) // 2
            out.append([self.host_at(mid), float(gaps[i]) * 1e-9])
        return out

    def host_at(self, t: int) -> str:
        if not len(self.host_starts):
            return "host (not traced)"
        cover = (self.host_starts <= t) & (self.host_ends >= t)
        if not cover.any():
            return "host (no traced op: Python or numpy work)"
        idx = np.nonzero(cover)[0]
        inner = idx[np.argmin(self.host_ends[idx] - self.host_starts[idx])]
        return short(self.host_names[inner])


def short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n]


def union(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Merged intervals of [starts, ends) clipped to [lo, hi): (n, 2) int64, sorted."""
    s = np.clip(np.asarray(starts, np.int64), lo, hi)
    e = np.clip(np.asarray(ends, np.int64), lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if not len(s):
        return np.zeros((0, 2), np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > run_end[:-1]
    firsts = np.nonzero(new)[0]
    lasts = np.append(firsts[1:] - 1, len(s) - 1)
    return np.stack([s[firsts], run_end[lasts]], 1)


@contextlib.contextmanager
def traced(enabled: bool, device_type: str):
    """A profiler around the block when enabled (CPU and CUDA activity); yields a holder
    whose `.trace` is set on exit."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if device_type != "cuda":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(WINDOW):
                yield holder
        holder.trace = from_events(prof.profiler.kineto_results.events())
        return
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKS):
            torch.cuda._sleep(100)
        yield holder
        for _ in range(MARKS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
    holder.trace = from_events(prof.profiler.kineto_results.events())


def from_events(events: Sequence) -> Optional[Trace]:
    """Reduce kineto events (objects with name(), start_ns(), duration_ns(), device_type())."""
    from torch.autograd import DeviceType

    window = None
    dev, host, marks = [], [], []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if MARK in name:
                marks.append((start, end))
            elif name != WINDOW:  # an annotation's own span on the device is no operation
                dev.append((start, end, name))
            continue
        if name == WINDOW:
            window = (start, end)
            continue
        host.append((start, end, name))
    marks.sort()
    if window is None and len(marks) >= 2:
        window = (marks[0][0], marks[-1][1])
    elif window is None and dev:  # the markers were not recorded: the device's own span
        window = (min(d[0] for d in dev), max(d[1] for d in dev))
    if window is None:
        return None
    lo, hi = window
    dev = sorted(d for d in dev if d[1] > lo and d[0] < hi)
    host = [h for h in host if h[1] > lo and h[0] < hi]
    # every recorded marker but the first is launched inside the window
    launches = sum(1 for h in host if h[2] in LAUNCH_CALLS) - max(len(marks) - 1, 0)
    return Trace(names=[d[2] for d in dev], starts=np.array([d[0] for d in dev], np.int64),
                 ends=np.array([d[1] for d in dev], np.int64), window=window,
                 launches=launches, host_names=[h[2] for h in host],
                 host_starts=np.array([h[0] for h in host], np.int64),
                 host_ends=np.array([h[1] for h in host], np.int64))
