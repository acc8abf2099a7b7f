"""Reading a profiled slice: device busy time, kernel time by name, and the
longest idle gaps labelled by what the host was doing.

Everything here works on plain intervals, (start, end) in microseconds, so
that the arithmetic is tested without a card (`stats` holds the union).
"""

from __future__ import annotations

from collections import defaultdict

from planbench import stats


def label_at(t: float, spans: list[tuple]) -> str:
    """The innermost host range (name, start, end) covering time t: the
    harness's span, and within it the innermost program operation."""
    mine = [s for s in spans if s[1] <= t <= s[2] and s[0].startswith("pb:")]
    ops = [s for s in spans if s[1] <= t <= s[2] and not s[0].startswith("pb:")]
    inner = lambda ss: min(ss, key=lambda s: s[2] - s[1])[0] if ss else None
    a, b = inner(mine), inner(ops)
    a = a[3:] if a else "host"
    return a if b is None else f"{a} / {b}"


def breakdown(device: list[tuple], host: list[tuple], t0: float, t1: float,
              top: int = 10) -> dict:
    """device: (name, start, end) of every kernel and copy; host: (name,
    start, end) of the host's ranges; [t0, t1] the slice.  The `top`
    device operations by summed seconds, and the `top` longest idle gaps in
    the slice, each labelled by the host range at its middle."""
    per = defaultdict(float)
    for name, s, e in device:
        per[name] += (e - s) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps = stats.gaps([(s, e) for _, s, e in device], t0, t1)
    gaps = sorted(gaps, key=lambda g: -(g[1] - g[0]))[:top]
    return {
        "device_ops": [[name[:120], sec] for name, sec in ops],
        "idle_gaps": [[label_at((s + e) / 2, host), (e - s) / 1e6] for s, e in gaps],
    }


def summarize(events, window_s: float, items: int) -> dict:
    """A torch.profiler slice (its `events()`) of `items` items lasting
    window_s on the host clock."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        tr = e.time_range
        row = (e.name, float(tr.start), float(tr.end))
        if e.device_type == DeviceType.CUDA:
            # the harness's own labelled ranges are mirrored on the device's
            # timeline; they are no device work
            if not e.name.startswith("pb:"):
                device.append(row)
        else:
            host.append(row)
    slice_ = [h for h in host if h[0] == "pb:slice"]
    t0, t1 = ((slice_[0][1], slice_[0][2]) if slice_
              else (min(r[1] for r in host), max(r[2] for r in host)))
    per = defaultdict(float)
    for name, s, e in device:
        per[name] += (e - s) / 1e6
    busy = stats.union_length([(s, e) for _, s, e in device]) / 1e6
    return {
        "busy_s": busy,
        "window_s": window_s,
        "items": items,
        "kernels": dict(per),
        "breakdown": breakdown(device, host, t0, t1),
    }
