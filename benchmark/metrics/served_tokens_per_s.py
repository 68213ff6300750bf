"""Every prompt token of a request whose first token reached the host
inside the window, and every output token that reached the host inside
it, over the window's seconds: the tokens a saturated engine completed."""


def read(run):
    prompt = sum(len(r.prompt) for r in run.records.values()
                 if r.first is not None and 0 <= r.first < run.seconds)
    out = sum(k for t, k in run.arrivals if 0 <= t < run.seconds)
    return (prompt + out) / run.seconds if prompt + out else None
