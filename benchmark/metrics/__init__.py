"""One reader a metric: `read(run)` returns the metric's value, or None
when the run holds nothing for it to read. The harness loads
`<name>.py`, else `<name up to the first dot>.py`."""
