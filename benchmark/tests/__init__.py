"""CPU tests of the benchmark (python3 -m pytest benchmark/tests -q); the
ones marked `cuda` run on the card and skip here."""
