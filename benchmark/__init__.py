"""The benchmark of the PyTorch / CUDA port (audio_algebra_torch).

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

runs one cell of BENCHMARK.json once on the card and prints one JSON line.
Configurations (`configs/`), traffic mixes (`traffic/*.json`), metric
readers (`metrics/`), operation and byte counts (`counts/`) and the plain
reference (`reference/`) are files found by the names BENCHMARK.json
gives."""
