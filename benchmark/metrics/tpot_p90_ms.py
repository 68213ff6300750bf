"""The 90th percentile, over every request whose first and last tokens both
reached the host inside the window, of (t_last - t_first) / (n - 1)."""

from benchmark.reading import p90


def read(run):
    per = [1e3 * (r.last - r.first) / (r.n - 1)
           for r in run.records.values()
           if r.first is not None and r.last is not None and r.n > 1
           and 0 <= r.first and r.last < run.seconds]
    return p90(per)
