"""The device trace of a traced run, reduced in memory.

Traced: CPU and CUDA activity through torch's Kineto profiler, read as raw
events (no export, no event tree). Reduced to the union of device activity
(kernels, copies and fills; not the ranges that a record_function mirrors
onto the device's timeline) as busy seconds, the device operations that
took most time, and the longest idle gaps named by what the host was
doing.
"""

import numpy as np
import torch

# idle gaps named, longest first
NAMED_GAPS = 500
# characters kept of an operation's name (kernel names run to thousands)
NAME_CHARS = 160


class DeviceTrace:
    """Profile between start() and stop(); the result is summary()."""

    def __init__(self):
        self.activities = {torch.profiler.ProfilerActivity.CPU}
        if torch.cuda.is_available():
            self.activities.add(torch.profiler.ProfilerActivity.CUDA)
        self.events = None

    def start(self):
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)

        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                             False, False,
                             torch._C._profiler._ExperimentalConfig())
        _prepare_profiler(cfg, self.activities)
        _enable_profiler(cfg, self.activities)

    def stop(self):
        from torch.autograd import _disable_profiler

        result = _disable_profiler()
        self.events = result.events()

    def summary(self, lo_ns, hi_ns, top=10):
        """{busy_s, window_s, device_ops, idle_gaps} of the device activity
        between lo_ns and hi_ns (time.time_ns() readings, the profiler's
        clock), the traced window."""
        dev, host = [], []
        for e in self.events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                s, t = max(start, lo_ns), min(start + dur, hi_ns)
                if t > s:
                    dev.append((s, t, e.name()))
            elif dur > 0:
                host.append((start, start + dur, e.name()))
        # a record_function range is mirrored onto the device's timeline
        # under its host name; kernels never share a name with a host range
        host_names = {name for _, _, name in host}
        dev = sorted(d for d in dev if d[2] not in host_names)
        busy = 0
        gaps = []
        cur_s = cur_e = None
        for s, e, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((s - cur_e, cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        by_name = {}
        for s, e, name in dev:
            by_name[name] = by_name.get(name, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        # name the longest gaps by the innermost host range open at their
        # middle, else by the host range that ended last before it, and sum
        # the idle time by name
        gaps.sort(reverse=True)
        hs = np.array([h[0] for h in host], dtype=np.int64)
        he = np.array([h[1] for h in host], dtype=np.int64)
        named = {}
        for length, s, e in gaps[:NAMED_GAPS]:
            mid = (s + e) // 2
            hit = np.flatnonzero((hs <= mid) & (he >= mid))
            if hit.size:
                name = host[hit[np.argmin(he[hit] - hs[hit])]][2]
            else:
                done = np.flatnonzero(he < mid)
                name = ("after " + host[done[np.argmax(he[done])]][2]
                        if done.size else "no host range")
            named[name] = named.get(name, 0) + length
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {
            "busy_s": busy / 1e9,
            "window_s": (hi_ns - lo_ns) / 1e9,
            "device_ops": [[n[:NAME_CHARS], v / 1e9] for n, v in ops],
            "idle_gaps": [[n[:NAME_CHARS], v / 1e9] for n, v in idle],
        }

