"""The device trace of a window, and the host spans that explain its gaps.

``Spans`` wraps calls into the program's layers (from the benchmark's
side, by patching the module attributes the program calls through) and
keeps (name, start, end) on the wall clock in nanoseconds, the clock the
profiler's events carry.  ``window`` runs a cell's steps, traced or not,
``torch.profiler`` with the device activities only; ``summarise`` reduces
its events to the device's
busy time (the union of kernels, copies and sets), device time by kernel
name, and the idle time, each stretch of it named by the innermost host
span open then.
"""

import contextlib
import functools
import time
from unittest import mock


class Spans:
    def __init__(self):
        self.spans = []

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.spans.append((name, t0, time.time_ns()))
        return timed

    @contextlib.contextmanager
    def patched(self, targets):
        """Patch each (owner, attribute, span name) with its timed wrapper."""
        with contextlib.ExitStack() as stack:
            for owner, attr, name in targets:
                stack.enter_context(mock.patch.object(owner, attr,
                                                      self.wrap(name, getattr(owner, attr))))
            yield self


def window(step, seconds, device, trace=False, targets=(), recorder=None):
    """Run ``step()`` until ``seconds`` are spent; with ``trace``, under the
    spans of ``targets``, the ``recorder`` context and (on a card) the
    profiler.  Returns the window's seconds and, traced, its summary."""
    import torch
    spans, prof = Spans(), None
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(spans.patched(targets))
            stack.enter_context(recorder or contextlib.nullcontext())
            if device.type == "cuda":
                prof = stack.enter_context(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]))
        t0_ns, tic = time.time_ns(), time.perf_counter()
        while True:
            step()
            if time.perf_counter() - tic >= seconds:
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s, t1_ns = time.perf_counter() - tic, time.time_ns()
    if not trace:
        return window_s, None
    return window_s, summarise(device_events(prof) if prof else [], spans.spans, t0_ns, t1_ns)


def device_events(prof):
    """(name, start_ns, end_ns) of every activity that ran on a device."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def summarise(events, spans, t0_ns, t1_ns, top=10):
    """busy_s, window_s, per-kernel seconds, the top device operations and
    the longest idle gaps (named by host span) of a traced window."""
    events = sorted((max(a, t0_ns), min(b, t1_ns), n) for n, a, b in events
                    if b > t0_ns and a < t1_ns)
    busy, end, gaps = 0, t0_ns, []
    for a, b, _ in events:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1_ns > end:
        gaps.append((end, t1_ns))
    by_name = {}
    for a, b, n in events:
        by_name[n] = by_name.get(n, 0) + (b - a)
    # One sweep over span and gap edges: each stretch of idle time goes to
    # the innermost open span, the one opened last (the wrapped calls nest
    # on one thread).
    marks = [(a, 0, k) for k, (_, a, _) in enumerate(spans)]
    marks += [(b, 1, k) for k, (_, _, b) in enumerate(spans)]
    marks += [(a, 2, None) for a, _ in gaps] + [(b, 3, None) for _, b in gaps]
    marks.sort(key=lambda m: (m[0], m[1]))
    open_, idle, in_gap, prev = [], {}, False, t0_ns
    for t, kind, k in marks:
        if in_gap and t > prev:
            name = spans[open_[-1]][0] if open_ else "outside any span"
            idle[name] = idle.get(name, 0) + (t - prev)
        prev = max(prev, t)
        if kind == 0:
            open_.append(k)
        elif kind == 1:
            open_.remove(k)
        else:
            in_gap = kind == 2
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "kernels_s": {n: v / 1e9 for n, v in by_name.items()},
            "device_ops": [[n[:120], v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in sorted(idle.items(),
                                                           key=lambda kv: -kv[1])[:top]],
            "n_events": len(events)}


def roofline_pct(run, bytes_key, kernel):
    """The share of its roofline that a kernel reads over a traced window:
    the bytes its launches need (``run[bytes_key]``) over the card's HBM
    bandwidth (``peaks.json``), as a share of the device time of every
    activity whose name holds ``kernel``.  None where nothing was traced."""
    import json
    import os
    tr = run.get("trace")
    if not tr or not run.get(bytes_key):
        return None
    kernel_s = sum(v for k, v in tr["kernels_s"].items() if kernel in k)
    if kernel_s <= 0:
        return None
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as fh:
        bw = json.load(fh)["H100"]["hbm_bytes_per_s"]
    return 100.0 * run[bytes_key] / bw / kernel_s
