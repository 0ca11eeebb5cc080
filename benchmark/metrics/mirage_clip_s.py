"""One user's wall seconds per clip: the window's time up to its last
completed request over the requests completed (metrics/_window.py)."""
from benchmark.metrics._window import seconds_per_request as read  # noqa: F401
