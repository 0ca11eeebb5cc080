"""Traffic: mixes as data files (`<name>.json`) and the generator modules
they name (`closed_loop.py`)."""
