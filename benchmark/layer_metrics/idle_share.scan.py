"""Percent of a scan's wall in which no kernel ran on the card: the
device's busy seconds a profiled scan over the median wall of the window's
scans outside the profiler."""


def read(lc):
    return lc.idle_pct()
