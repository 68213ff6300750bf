"""Engine admission: the mean wall ms of one admission tick
(_advance_prefill) in the window."""


def read(run):
    spans = run.window("engine.prefill")
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)
