"""The plain reference of the benchmark: the measured models' forward
passes and samplers in plain PyTorch and f32, written from their
published descriptions, importing nothing of the measured program; its
weights are drawn again from the run's seed (benchmark/weights.py)."""
