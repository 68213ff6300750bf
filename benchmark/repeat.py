"""Run cells of the benchmark several times, each run a process of its own,
and summarise them: the tool for measuring spreads and for reading the
correctness numbers over many seeds.

    python3 benchmark/repeat.py --out runs.jsonl \
        JOB [JOB ...]

A JOB is `workload,seed,seconds,trace[,control]`; the jobs run in order
(control 1: run.py --control 1).
Each run's result line, exit code, wall time and the end of its standard
error go to one line of --out; the summary goes to standard output: for
each (workload, trace) the values of each metric and check, and for each
metric its median and its spread (the distance between the first and the
third quartile by statistics.quantiles, over the median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values: list) -> float:
    if len(values) < 2:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("jobs", nargs="+")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    print(f"card: {card_line()}", flush=True)
    rows = []
    for job in args.jobs:
        w, seed, seconds, tr, *rest = job.split(",")
        cmd = [sys.executable, str(RUN), "--workload", w, "--seed", seed,
               "--seconds", seconds, "--trace", tr]
        if rest and rest[0] == "1":
            cmd += ["--control", "1"]
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            rc, so, se = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, so, se = 124, e.stdout or "", e.stderr or ""
            so = so.decode() if isinstance(so, bytes) else so
            se = se.decode() if isinstance(se, bytes) else se
        wall = time.perf_counter() - t0
        result = None
        lines = so.strip().splitlines()
        if rc == 0 and lines:
            try:
                result = json.loads(lines[-1])
            except json.JSONDecodeError:
                pass
        row = {"workload": w, "seed": int(seed), "trace": int(tr),
               "rc": rc, "wall_s": wall, "result": result,
               "stderr": se[-6000:]}
        rows.append(row)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        brief = {} if result is None else {
            "correct": result["correct"],
            **{k: v["value"] for k, v in result["metrics"].items()},
            **{k: v["value"] for k, v in result["checks"].items()},
            **{f"read.{k}": v for k, v in result.get("readings", {}).items()
               if "mean" in k or k in ("requests", "tokens")}}
        print(f"{w} seed {seed} trace {tr}: rc {rc}, {wall:.1f} s, "
              f"{json.dumps(brief)}", flush=True)
        if result is None:
            print(se[-3000:], flush=True)
    groups = {}
    for r in rows:
        if r["result"]:
            groups.setdefault((r["workload"], r["trace"]), []).append(r)
    for (w, tr), rs in groups.items():
        names = list(rs[0]["result"]["metrics"])
        print(f"== {w} trace {tr}: {len(rs)} runs", flush=True)
        for n in names:
            v = [r["result"]["metrics"][n]["value"] for r in rs
                 if n in r["result"]["metrics"]]
            print(f"  {n}: median {statistics.median(v):.6g} spread "
                  f"{spread(v):.4f} values {[round(x, 4) for x in v]}")
        for n in rs[0]["result"]["checks"]:
            v = [r["result"]["checks"][n]["value"] for r in rs]
            print(f"  check {n}: {v}")
        for n in rs[0]["result"].get("readings", {}):
            v = [r["result"]["readings"].get(n) for r in rs]
            print(f"  reading {n}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
