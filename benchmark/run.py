"""Entry point: `python3 -m benchmark.run --workload NAME --seed N
--seconds S --trace 0|1` from the root of a checkout (see harness.py)."""
import time

T_PROCESS = time.perf_counter()      # set-up is timed from here

if __name__ == "__main__":
    import sys

    from benchmark.harness import main
    sys.exit(main(t_process=T_PROCESS))
