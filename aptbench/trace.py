"""What a ``torch.profiler`` window says: the device's busy time (the union
of its kernel, copy and memset events), each kernel's time by name, and
the device's idle gaps, each labelled by what the host was doing."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from . import stats

MIN_LABELLED_GAP_NS = 50_000  # shorter idle gaps are summed under one label
SHORT = "gaps under 50 us"


def kernel_name(name: str) -> str:
    """A kernel's name without its trailing parameter list (a copy's name,
    such as ``Memcpy HtoD (Pinned -> Device)``, stays whole)."""
    if name.endswith(")") and ("::" in name or name.startswith("void ")):
        depth = 0
        for j in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[j], 0)
            if depth == 0:
                name = name[:j]
                break
    return name.strip()[:160]


@dataclass
class Trace:
    """Events of one traced window, in the profiler's nanoseconds."""

    lo: int
    hi: int
    device: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)  # (name, start, end), harness spans included

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return stats.union_length((a, b) for _, a, b in self.device) / 1e9

    def kernel_seconds(self, patterns) -> float:
        """Seconds of the device events whose name holds one of ``patterns``."""
        return sum(b - a for n, a, b in self.device if any(p in n for p in patterns)) / 1e9

    def device_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, a, b in self.device:
            k = kernel_name(name)
            by[k] = by.get(k, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds of the device by label, the largest ``n``: each gap
        of at least 50 us goes to the shortest host event or harness span
        that covers half of it or more, else to the one that overlaps it
        most; shorter gaps are summed together."""
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        longest = max((b - a for _, a, b in host), default=0)
        by: dict = {}
        for a, b in stats.gaps([(s, e) for _, s, e in self.device], self.lo, self.hi):
            if b - a < MIN_LABELLED_GAP_NS:
                by[SHORT] = by.get(SHORT, 0) + (b - a)
                continue
            label, best_over, best_cover = "harness", 0, None
            for i in range(bisect.bisect_left(starts, a - longest), bisect.bisect_left(starts, b)):
                name, s, e = host[i]
                over = min(b, e) - max(a, s)
                if over <= 0:
                    continue
                if 2 * over >= b - a and (best_cover is None or e - s < best_cover[1]):
                    best_cover = (name, e - s)
                if over > best_over:
                    best_over, label = over, name
            if best_cover is not None:
                label = best_cover[0]
            by[label] = by.get(label, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def from_profiler(prof, spans) -> Trace:
    """A :class:`Trace` of ``prof`` over the harness's ``spans``
    (``(label, t0_ns, t1_ns)`` on the host's ``perf_counter_ns`` clock,
    the first of each call named as in its ``record_function``), moved
    onto the profiler's clock by the offset of the calls' own spans."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    call_labels = {s[0] for s in spans if s[3]}
    device, host = [], []
    for e in events:
        a = e.start_ns()
        rec = (e.name(), a, a + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            host.append(rec)
        elif not e.is_user_annotation() and e.name() not in call_labels:
            device.append(rec)  # kernels, copies and memsets, not the annotations' mirror
    marks = sorted(h[1] for h in host if h[0] in call_labels)
    calls = sorted(s[1] for s in spans if s[3])
    if not marks or len(marks) != len(calls):
        raise RuntimeError(f"the profile holds {len(marks)} call spans for {len(calls)} calls")
    offsets = sorted(m - c for m, c in zip(marks, calls))
    off = offsets[len(offsets) // 2]
    host = [h for h in host if h[0] not in call_labels]
    host += [(label, a + off, b + off) for label, a, b, _ in spans]
    lo = min(s[1] for s in spans) + off
    hi = max(s[2] for s in spans) + off
    device = [(n, max(a, lo), min(b, hi)) for n, a, b in device if b > lo and a < hi]
    return Trace(lo, hi, device, host)
