"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 1]

From the root of a checkout: builds the cell's model from the seed on the
card, warms up every shape its traffic uses (set-up, `setup_s`), serves the
traffic for `s` seconds, then checks what was served against the plain
reference. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics, read from spans and a device trace of a
slice of the window), `device`, `breakdown` (traced), `readings` (every
number the check read) and `checks` (each number compared, with its
limit), which comes last. The checks are also the last lines of standard
error. --control 1 puts the precision control (check.py) in the
program's place: the run serves as usual, and its checks hold the
control's numbers on the same sample to the same limits, so that
`correct` comes out false.

Exits 2, printing no result, without enough CUDA cards; exits 3 if a JAX
module or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))
# every build and kernel cache at a fixed place inside the checkout, beside
# the port's own nvcc build (petit_kernel_tpu_torch/_build/)
_CACHES = CHECKOUT / "petit_kernel_tpu_torch" / "_build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHES / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHES / "triton")

# the JAX package, JAX itself, and the script that imports them
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "petit_kernel_tpu",
                       "chip_smoke"))
# a served tail needs some hundreds of tokens in the check, and a batch
# some of its rows
CHECK_TOKENS = 2048
CHECK_REQUESTS = 8
# the traced slice: short enough that the profiler keeps every record
SLICE_S = 1.5


def process_age() -> float:
    """Seconds this process had run when the script started (interpreter
    start-up), from /proc; 0 where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - _T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def launch_counts() -> dict:
    """The eager launch counters of the port's kernel wrappers (graph
    replays do not move them)."""
    from petit_kernel_tpu_torch.ops.kernels import (attention, fused,
                                                    grouped, hybrid)
    out = {}
    for mod in (attention, fused, grouped, hybrid):
        for name, fn in vars(mod).items():
            for counter in ("launches", "wgmma_launches", "stream_launches"):
                n = getattr(fn, counter, None)
                if callable(fn) and isinstance(n, int):
                    out[f"{name}.{counter}"] = n
    return out


def run_cell(bench, name: str, seed: int, seconds: float, traced: bool,
             device, control: bool = False, t_start: float = None) -> dict:
    import torch

    from benchmark import check, reading, serve, trace, traffic, work

    t_start = _T_START if t_start is None else t_start
    age = process_age() if t_start == _T_START else 0.0
    w = bench.workload(name)
    conf = bench.config(w["config"])
    mix = bench.mix(w["traffic"])
    cell = bench.cell(name)
    cuda = device.type == "cuda"
    vocab = conf["vocab_size"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    eng = bench.program(conf).build(conf, seed, mix["slots"], device)
    serve.warm_up(eng, mix, vocab)
    rec = serve.Recorder()
    serve.instrument(eng, work.Model(conf), rec)
    tracker = serve.Tracker(eng)
    reqs = traffic.stream(mix, seed, vocab, rate=cell.get("rate"))
    tracer = trace.Tracer(device) if traced else None
    slicer = serve.Slicer(tracer, 0.4 * seconds, min(SLICE_S, 0.2 * seconds),
                          now=tracker.now)
    launches0, caps0 = launch_counts(), serve.captures(eng)
    late = {}
    if mix["loop"] == "open":
        late = serve.open_loop(eng, tracker, reqs, mix, seconds, slicer)
    else:
        serve.closed_loop(eng, tracker, reqs, mix, seconds, slicer)
    end = tracker.now()
    setup_s = tracker.t0 - t_start + age
    caps = serve.captures(eng) - caps0
    launches = {k: v - launches0.get(k, 0)
                for k, v in launch_counts().items()
                if v != launches0.get(k, 0)}
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    run = reading.Run(
        seconds=seconds, setup_s=setup_s, records=tracker.records,
        arrivals=tracker.arrivals, spans=rec.spans, t0=tracker.t0, end=end,
        missing=rec.missing, families=bench.families(),
        peaks=work.peaks(kind) if cuda else None,
        slice_=tracer.result if tracer else None)
    if run.slice is not None:
        # each forward writes the KV cache once a layer: fewer writes in
        # the trace than forwards in the slice means the profiler lost
        # records, and no device metric is read from it
        writes = sum(1 for k, _, _ in run.slice.kernels
                     if trace.matches(k, run.families["kv_append"]["patterns"]))
        want = run.forwards_in_slice() * conf["num_hidden_layers"]
        log(f"[bench] trace: {len(run.slice.kernels)} device records, "
            f"{writes} KV writes for {want} expected, "
            f"{run.slice.seconds:.3f} s")
        if writes < want:
            log("[bench] the trace lost records: no device metric")
            run.slice = None
    metrics = {}
    for m in bench.metrics(name, traced):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = sum(r.sent is not None and r.sent < seconds
                    for r in tracker.records.values())
    # a finished request that served another number of tokens than it
    # asked for (greedy, no end token) failed
    wrong = {r.uid for r in tracker.records.values()
             if r.tokens is not None and len(r.tokens) != r.max_new}
    failed = sum(r.sent is not None and r.sent < seconds
                 for r in tracker.records.values() if r.uid in wrong)
    log(f"[bench] {name} seed {seed}: set-up {setup_s:.3f} s, window "
        f"{seconds} s, served until {end:.3f} s; requests sent "
        f"{len(tracker.records)}, finished "
        f"{sum(r.tokens is not None for r in tracker.records.values())}")
    log(f"[bench] memory peak {peak} bytes ({kind})")
    log(f"[bench] graph captures inside the window: {caps}")
    log(f"[bench] eager launches inside the window: "
        f"{json.dumps(launches, sort_keys=True)}")
    if late:
        log(f"[bench] generator lateness: {json.dumps(late)}")
    if rec.missing:
        log(f"[bench] spans missing (engine methods gone): {rec.missing}")

    # the program's state goes before the reference runs
    records = tracker.records
    del eng, rec, tracker, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picked = check.sample(records, seed, CHECK_TOKENS, CHECK_REQUESTS)
    limits = cell.get("limits", {})
    got = {}
    if picked:
        t_ref = time.perf_counter()
        got = check.compare(bench.reference(conf), conf, seed, device,
                            picked, control)
        log(f"[bench] reference over {got['requests']} requests, "
            f"{got['tokens']} served tokens: "
            f"{time.perf_counter() - t_ref:.3f} s")
        log(f"[bench] readings: {json.dumps(got)}")
    else:
        log("[bench] no request finished: nothing to check")
    # the control stands in the program's place
    prefix = "control_" if control else ""
    checks = {k: {"value": got.get(prefix + k), "limit": v}
              for k, v in sorted(limits.items())}
    checks["wrong_lengths"] = {"value": len(wrong), "limit": 0}
    correct = bool(limits) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    device_out = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_out}
    if traced and tracer.result is not None:
        sl = tracer.result
        device_out["busy_s"] = trace.busy_ns(sl) / 1e9
        device_out["window_s"] = sl.seconds
        out["breakdown"] = trace.breakdown(sl, bench.families())
    out["readings"] = got
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec

    bench = spec.Bench.at(CHECKOUT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[bench] {args.workload} needs {chips} CUDA card(s); "
            f"available: {torch.cuda.device_count()}")
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda"),
                   control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        log(f"[bench] loaded in this process: {bad}")
        return 3
    for k, c in out["checks"].items():
        log(f"[check] {k} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
