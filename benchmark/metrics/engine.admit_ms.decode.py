"""Engine scheduling (models/serving.py): wall ms in admission ticks
(_advance_prefill: a prompt's chunk, or one batched forward over the
same-key chunks) for each prompt that finished its prefill in the window."""


def read(run):
    spans = run.window("engine.prefill")
    done = sum(s.attrs["done"] for s in spans)
    if not done:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / done
