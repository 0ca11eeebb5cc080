"""Seconds of audio returned per wall second over the window's whole
requests (metrics/_window.py)."""
from benchmark.metrics._window import audio_rate as read  # noqa: F401
