"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CUDA
activity alone over the measured window, so that the host runs as in an
untraced run but for the profiler's record of each launch, reduced to what
the per-layer metrics and the result's ``breakdown`` read.  The benchmark's
own host spans (window, request, enqueue, sync, job) are taken with
``time.time_ns``, the clock of the profiler's timestamps.

- Device intervals: every kernel, copy and set on the card (the device's
  copies of the host's annotations are left out).  ``busy_s`` is the length
  of their union inside the window (the timeline's union, not a sum of
  durations, so the idle share cannot read below 0); ``window_s`` the
  window's length.
- Kernel seconds by name: the sum of a kernel's durations in the window.
- Idle gaps: the stretches of the window with nothing on the card, each
  named by the benchmark's innermost host span at its middle and by the
  device operations on either side of it (``job/Memcpy DtoH>fill``: in a
  fit job, between a copy to the host and a fill), summed by name.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch


class Spans:
    """The benchmark's host spans: ``(name, start ns, end ns)``, nested."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, start, time.time_ns()))


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yield a profiler of the card's activity over the block (``None`` when
    not ``enabled``; the host's where there is no card, for the tests)."""
    if not enabled:
        yield None
        return
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA if torch.cuda.is_available() else act.CPU]) as prof:
        yield prof


_DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}


def _on_device(e) -> bool:
    """A kernel, copy or set on the card: not a host event, and not the
    device's copy of a host annotation (``Optimizer.step#Adam.step``)."""
    if "cuda" not in str(e.device_type()).lower():
        return False
    kind = getattr(e, "activity_type", None)
    if callable(kind):
        return kind() in _DEVICE_ACTIVITIES
    annotation = getattr(e, "is_user_annotation", None)
    if callable(annotation) and annotation():
        return False
    name = e.name()
    return not ("#" in name and "(" not in name)


def short(name: str) -> str:
    """A device operation's name without its template arguments, namespaces
    and signature: ``at::native::...::CatArrayBatchedCopy<...>(...)`` ->
    ``CatArrayBatchedCopy``."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return " ".join(name.split()[:2])
    depth, out = 0, []
    for ch in name:
        depth += ch in "<("
        if depth == 0:
            out.append(ch)
        depth -= ch in ">)"
    base = "".join(out).replace("void ", "").strip()
    return base.split("::")[-1] or name[:64]


@dataclasses.dataclass
class Trace:
    window: tuple  # (start ns, end ns)
    device: list  # [(start ns, end ns, name)]
    spans: list  # [(name, start ns, end ns)]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _clipped(self):
        w0, w1 = self.window
        for s, e, n in self.device:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                yield s, e, n

    def busy_intervals(self) -> list:
        """The union of the device's intervals inside the window."""
        out = []
        for s, e, _ in sorted(self._clipped()):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_s(self, *names: str) -> float:
        """Seconds of the device operations whose name holds any of ``names``."""
        return sum(e - s for s, e, n in self._clipped() if any(x in n for x in names)) * 1e-9

    def top_ops(self, k: int = 10) -> list:
        """The device operations that took most time, by the profiler's
        name (cut at 160 characters)."""
        by = {}
        for s, e, n in self._clipped():
            by[n] = by.get(n, 0) + (e - s)
        return [[n[:160], t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle seconds summed by name, longest first (module docstring)."""
        ops = list(self._clipped())
        starts = sorted((s, n) for s, _, n in ops)
        ends = sorted((e, n) for _, e, n in ops)
        spans = sorted(((s, e, n) for n, s, e in self.spans), key=lambda x: (x[0], -x[1]))
        by, t, stack, i = {}, self.window[0], [], 0
        for b0, b1 in self.busy_intervals() + [[self.window[1], self.window[1]]]:
            if b0 > t:
                mid = (t + b0) // 2
                while i < len(spans) and spans[i][0] <= mid:
                    stack.append(spans[i])
                    i += 1
                stack = [sp for sp in stack if sp[1] > mid]
                where = min(stack, key=lambda sp: sp[1] - sp[0])[2] if stack else "window"
                j = bisect.bisect_right(ends, (t, "\uffff"))
                before = short(ends[j - 1][1]) if j > 0 else "start"
                j = bisect.bisect_left(starts, (b0, ""))
                after = short(starts[j][1]) if j < len(starts) else "end"
                name = f"{where}/{before}>{after}"
                by[name] = by.get(name, 0) + (b0 - t)
            t = max(t, b1)
        return [[n, s * 1e-9] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def reduce(prof, spans: Spans) -> Trace:
    """The profiler's device events and the host's spans as a :class:`Trace`;
    the window is the span named ``window``."""
    device = []
    for e in prof.profiler.kineto_results.events():
        if _on_device(e):
            start = e.start_ns()
            end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
            device.append((start, end, e.name()))
    window = next((s, e) for n, s, e in spans.items if n == "window")
    return Trace(window=window, device=device, spans=[x for x in spans.items if x[0] != "window"])
