"""The window's arithmetic: rates and times count whole requests that
ended inside the window, and divide by the time to the last of them."""
from __future__ import annotations

import pytest

from benchmark.harness import Run, reader
from benchmark.traffic.closed_loop import Record


def _rec(t0, t1, audio_s=10.0, error=None):
    r = Record(0, 0, 0, False)
    r.t0, r.t1, r.error = t0, t1, error
    r.out = None if error else {"audio_s": audio_s}
    return r


def _run(records, t_start=100.0, seconds=30.0):
    return Run(records=records, t_start=t_start, t_close=t_start + seconds)


RECS = [_rec(100.0, 108.0), _rec(108.0, 116.0), _rec(116.0, 124.0),
        _rec(124.0, 126.0, error="Traceback"),          # failed: counts in no rate
        _rec(126.0, 134.0)]                              # ends after the close


def test_audio_rate_counts_whole_requests_only():
    for name in ("destructo_audio_per_s", "mirage_audio_per_s"):
        assert reader(name)(_run(RECS)) == pytest.approx(30.0 / 24.0)


def test_clip_seconds_counts_whole_requests_only():
    assert reader("mirage_clip_s")(_run(RECS)) == pytest.approx(24.0 / 3)


def test_coalesced_groups_share_one_end():
    recs = [_rec(100.0, 110.0) for _ in range(4)] + [_rec(110.0, 120.0) for _ in range(4)]
    assert reader("mirage_audio_per_s")(_run(recs)) == pytest.approx(80.0 / 20.0)
    assert reader("mirage_clip_s")(_run(recs)) == pytest.approx(20.0 / 8)


def test_nothing_completed_reads_nothing():
    run = _run([_rec(100.0, 140.0)])
    assert reader("destructo_audio_per_s")(run) is None
    assert reader("mirage_clip_s")(run) is None
