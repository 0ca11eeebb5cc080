"""Arithmetic shared by the end-to-end readers: whole requests only.

A rate counts the requests (or jobs) that ended without error inside the
window, and divides by the time from the window's start to the last of
those ends; a request still running at the close counts in no rate."""
from __future__ import annotations


def audio_rate(run):
    """Seconds of audio returned per wall second."""
    done = run.completed()
    if not done:
        return None
    return sum(r.out["audio_s"] for r in done) / (max(r.t1 for r in done) - run.t_start)


def seconds_per_request(run):
    """Wall seconds of the window per request completed in it."""
    done = run.completed()
    if not done:
        return None
    return (max(r.t1 for r in done) - run.t_start) / len(done)
