"""The device's idle time while the host is inside named spans, time-sliced.

Each idle gap of the traced window (``Records.idle_gaps``) is cut against
the union of the named spans' intervals, so a gap is charged only for the
part the host spent inside them: a gap that begins before a span and ends
inside it counts from the span's start. (``Records.breakdown`` charges a
whole gap to the span open when it begins.)
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering the given ones."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_us(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_s_inside(rec, names: Iterable[str]) -> Optional[float]:
    """Seconds of the window in which the device was idle and the host was
    inside one of the spans ``names``; None when none of them opened."""
    spans = [iv for n in names for iv in rec.spans.get(n, ())]
    if not spans:
        return None
    return overlap_us(rec.idle_gaps(), union(spans)) / 1e6
