"""The end-to-end metrics are taken over every request of the window, from
the client's side, and not from medians of pieces; the per-layer readers
return nothing where they have nothing to read."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import reading, serve


def _run(records, arrivals, seconds=10.0, spans=(), missing=()):
    return reading.Run(seconds=seconds, setup_s=12.5,
                       records={r.uid: r for r in records},
                       arrivals=list(arrivals), spans=list(spans), t0=100.0,
                       end=seconds + 3.0, missing=list(missing),
                       families={}, peaks=None)


def _rec(uid, due=None, first=None, last=None, n=0, sent=None):
    return serve.Record(uid, np.zeros(4, np.int32), n, due=due, sent=sent,
                        first=first, last=last, n=n,
                        tokens=[0] * n if last is not None else None)


def _reader(tiny, name):
    return tiny.reader(name)


def test_p90_is_the_nearest_rank_over_all():
    assert reading.p90(range(1, 101)) == 90
    assert reading.p90([3.0]) == 3.0
    assert reading.p90([]) is None
    # 20 values: the 18th
    assert reading.p90(range(20)) == 17


def test_tpot_counts_requests_inside_the_window(tiny):
    recs = [_rec(i, first=1.0, last=1.0 + 0.02 * 99, n=100)
            for i in range(19)]
    recs.append(_rec(19, first=0.5, last=0.5 + 0.05 * 99, n=100))
    recs.append(_rec(20, first=-1.0, last=5.0, n=100))    # began before
    recs.append(_rec(21, first=8.0, last=12.0, n=100))    # ends after
    v = _reader(tiny, "tpot_p90_ms")(_run(recs, []))
    assert v == pytest.approx(20.0)
    for uid in (22, 23):
        recs.append(_rec(uid, first=0.5, last=0.5 + 0.05 * 99, n=100))
    v = _reader(tiny, "tpot_p90_ms")(_run(recs, []))
    assert v == pytest.approx(50.0)


def test_output_rate_counts_every_token_of_the_window(tiny):
    arrivals = [(t, 8) for t in np.arange(-1.0, 12.0, 0.5)]
    v = _reader(tiny, "output_tokens_per_s")(_run([], arrivals))
    assert v == pytest.approx(8 * 20 / 10.0)


def test_span_readers_are_absent_without_spans(tiny):
    run = _run([], [], missing=["_advance_prefill", "_run_decode_block"])
    for name in ("engine.admit_ms.decode", "blocks.step_ms.decode",
                 "engine.prefill_chunk_ms", "model.prefill_mfu",
                 "model.decode_step_mfu", "kernels.decode_gemm_roofline",
                 "device.idle_share.decode"):
        assert _reader(tiny, name)(run) is None


def test_block_wall_runs_from_dispatch_to_read(tiny):
    S = serve.Span
    spans = [S("blocks.run", 101.0, 101.001, {"steps": 8, "ops": []}),
             S("blocks.read", 101.002, 101.160, {}),
             S("engine.decode", 101.2, 101.24, {"steps": 1, "ops": []}),
             S("blocks.run", 130.0, 130.001, {"steps": 8, "ops": []}),
             S("blocks.read", 130.002, 130.2, {})]
    v = _reader(tiny, "blocks.step_ms.decode")(_run([], [], spans=spans))
    assert v == pytest.approx(1e3 * (0.160 + 0.04) / 9)
