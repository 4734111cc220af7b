"""The device trace of a traced run: ``torch.profiler`` over the first
jobs of the window.

``Profile`` holds what the metric readers take from it: the device's
busy seconds and the traced window's length, device seconds by kernel
name, and the idle gaps labelled by the program's span that was open
(the spans enter the trace as ``record_function`` ranges while
``repro_torch.obs.trace.enable_profiler_annotations`` is on).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

class Profile:
    def __init__(self, device_events, cpu_ranges, window):
        """``device_events``: (name, start_ns, end_ns) of every operation
        on the card; ``cpu_ranges``: (name, start_ns, end_ns) of the
        program's spans; ``window``: (start_ns, end_ns)."""
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        by_name = defaultdict(float)
        ivs = []
        for name, s, e in device_events:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            by_name[name] += (e - s) * 1e-9
            ivs.append((s, e))
        ivs.sort()
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        self.kernel_s = dict(by_name)
        gaps = []
        last = w0
        for s, e in merged + [[w1, w1]]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        self.gaps = [(self._label(cpu_ranges, (a + b) // 2), (b - a) * 1e-9)
                     for a, b in gaps]

    @staticmethod
    def _label(ranges, t):
        best = None
        for name, s, e in ranges:
            if s <= t <= e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "outside any span"

    def seconds(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(v for k, v in self.kernel_s.items() if match(k))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        idle = defaultdict(float)
        for label, sec in self.gaps:
            idle[label] += sec
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


WINDOW = "portbench.window"


class JobProfiler:
    """Profiles jobs 0..n_jobs-1 of the window as one traced window (the
    host's operations and the card's, and the program's spans as
    ``record_function`` ranges); sets ``ctx.profiling`` while it runs, so
    that probes count only there. The trace is read once the window has
    closed (``result``); recording the host's operations slows the
    traced jobs' host side, which the idle share then includes."""

    def __init__(self, ctx, n_jobs: int, on_card: bool):
        self.ctx = ctx
        self.n_jobs = n_jobs
        self.on_card = on_card
        self.prof = None
        self.window = None
        ctx.profiling = False

    @contextlib.contextmanager
    def job(self, j: int):
        if j >= self.n_jobs:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        if j == 0:
            acts = [ProfilerActivity.CPU]
            if self.on_card:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.window = record_function(WINDOW)
            self.window.__enter__()
            self.ctx.profiling = True
        yield
        if j == self.n_jobs - 1:
            if self.on_card:
                torch.cuda.synchronize()
            self.ctx.profiling = False
            self.window.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)

    def result(self):
        """The ``Profile`` of the traced jobs (None when nothing was
        traced)."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType

        from repro_torch.obs.trace import TRACER
        names = {s.name for s in TRACER.spans()}
        dev, cpu, window = [], [], None
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                # a span's range also shows on the device as a user
                # annotation over its kernels: not an operation
                if name not in names and name != WINDOW:
                    dev.append((name, s, e))
            elif name == WINDOW:
                window = (s, e)
            elif name in names:
                cpu.append((name, s, e))
        if window is None:
            return None
        return Profile(dev, cpu, window)
