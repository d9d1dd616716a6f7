"""The traced run's timeline: torch.profiler's chrome trace read back into
device intervals, host spans and the window.

``Timeline.from_events`` takes the trace's event list (``traceEvents``),
so the arithmetic is tested on synthetic timelines.  Times are in seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Timeline:
    """Device operations and host spans inside the traced window."""

    def __init__(self, device_ops, host_spans, window):
        self.window = window  # (start, end)
        w0, w1 = window
        self.device_ops = [(n, max(s, w0), min(e, w1)) for n, s, e in device_ops if e > w0 and s < w1]
        self.host_spans = sorted(((s, e, n) for n, s, e in host_spans), key=lambda x: x[0])
        self._starts = [h[0] for h in self.host_spans]
        self.busy = _merge([(s, e) for _, s, e in self.device_ops])

    @staticmethod
    def from_events(events: list, window_span: str = WINDOW_SPAN) -> "Timeline":
        dev, host, window = [], [], None
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"]) * 1e-6
            e = s + float(ev["dur"]) * 1e-6
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((ev.get("name", "?"), s, e))
            elif cat in HOST_CATS:
                if cat == "user_annotation" and ev.get("name") == window_span:
                    window = (s, e)
                host.append((ev.get("name", "?"), s, e))
        if window is None:
            raise ValueError(f"the trace holds no {window_span!r} span")
        return Timeline(dev, host, window)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(e - s for s, e in self.busy)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_seconds(self, pattern: str | None = None, exclude: str | None = None) -> float:
        """Summed device time of the operations whose name matches the
        regular expression ``pattern`` (all where None) and not ``exclude``."""
        inc = re.compile(pattern) if pattern else None
        exc = re.compile(exclude) if exclude else None
        return sum(e - s for n, s, e in self.device_ops
                   if (inc is None or inc.search(n)) and (exc is None or not exc.search(n)))

    def host_at(self, t: float) -> str:
        """The innermost host span running at ``t`` (the latest started
        that has not ended), or "idle host"."""
        i = bisect.bisect_right(self._starts, t)
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, e, n = self.host_spans[j]
            if s <= t < e:
                return n
        return "idle host"

    def idle_gaps(self):
        """[(start, end)] of the window's stretches with no device
        operation."""
        gaps, at = [], self.window[0]
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.window[1]:
            gaps.append((at, self.window[1]))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing at each gap's middle: [[name, seconds]]."""
        ops: dict = {}
        for n, s, e in self.device_ops:
            ops[n] = ops.get(n, 0.0) + (e - s)
        gaps: dict = {}
        for s, e in self.idle_gaps():
            n = self.host_at(0.5 * (s + e))
            gaps[n] = gaps.get(n, 0.0) + (e - s)

        def top_of(d):
            return [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")[:160]


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block's CPU and CUDA activity; on exit ``out["timeline"]``
    holds its :class:`Timeline` (the block must open a ``WINDOW_SPAN``
    ``record_function``).  The chrome trace goes through a temporary file
    under ``TMPDIR`` and is deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a session can drop its first device activities: spend them here
        x = torch.ones(1 << 16, device="cuda")
        for _ in range(8):
            x = x * 1.0001
        torch.cuda.synchronize()
        yield
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out["timeline"] = Timeline.from_events(events)
