"""Every output token that reached the host inside the window, over the
window's seconds."""


def read(run):
    n = sum(k for t, k in run.arrivals if 0 <= t < run.seconds)
    return n / run.seconds if n else None
