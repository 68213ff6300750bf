"""Find an open-loop cell's knee: the highest arrival rate it sustains
without a growing backlog. One process builds the cell's model once, then
serves the cell's mix at each rate given for `--seconds` (releasing every
slot in between), and prints for each rate the time to first token over
all requests due in the window and over its first and last thirds (the
engine runs on after the window until the requests it holds finish; one
still queued by the client counts to that end), the time they waited for
a slot, and the requests finished per second. A backlog grows where the
last third waits far longer than the first.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s>
        --rates 1,2,3 [--out sweep.jsonl]
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def _ms(values, q=None):
    if not values:
        return None
    if q is None:
        return 1e3 * statistics.median(values)
    return 1e3 * sorted(values)[math.ceil(q * len(values)) - 1]


def sweep(bench, name: str, seed: int, seconds: float, rates, device):
    from benchmark import serve, traffic
    w = bench.workload(name)
    conf = bench.config(w["config"])
    mix = bench.mix(w["traffic"])
    eng = bench.program(conf).build(conf, seed, mix["slots"], device)
    serve.warm_up(eng, mix, conf["vocab_size"])
    for rate in rates:
        tracker = serve.Tracker(eng)
        reqs = traffic.stream(mix, seed, conf["vocab_size"], rate=rate)
        serve.open_loop(eng, tracker, reqs, mix, seconds,
                        serve.Slicer(None, 0, 0))
        while eng.step_block(mix["block_steps"], waiters=True):
            tracker.poll()
        tracker.poll()
        eng.reset()
        due = [r for r in tracker.records.values() if r.due < seconds]
        end = tracker.now()

        def ttft(rs):
            return [(r.first if r.first is not None else end) - r.due
                    for r in rs]

        third = [r for r in due if r.due < seconds / 3]
        last = [r for r in due if r.due >= 2 * seconds / 3]
        done = sum(r.last is not None and r.last < seconds for r in due)
        yield {"workload": name, "rate": rate, "due": len(due),
               "ttft_p50_ms": _ms(ttft(due)),
               "ttft_p90_ms": _ms(ttft(due), 0.9),
               "ttft_first_third_p50_ms": _ms(ttft(third)),
               "ttft_last_third_p50_ms": _ms(ttft(last)),
               "wait_first_third_p50_ms": _ms(
                   [r.sent - r.due for r in third if r.sent is not None]),
               "wait_last_third_p50_ms": _ms(
                   [r.sent - r.due for r in last if r.sent is not None]),
               "finished_per_s": done / seconds,
               "unserved": sum(r.first is None for r in due)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.Bench.at(CHECKOUT)
    rates = [float(r) for r in args.rates.split(",")]
    for row in sweep(bench, args.workload, args.seed, args.seconds, rates,
                     torch.device("cuda")):
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
