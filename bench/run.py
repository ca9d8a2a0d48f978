"""Run one benchmark cell once and print its result as the last line:

    python3 bench/run.py --workload qwen2-7b.chat --seed 7 --seconds 30 \\
        --trace 0

See bench/README.md."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchlib.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
