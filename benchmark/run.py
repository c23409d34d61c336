"""Run one cell of the benchmark of ``news_recsys_tpu_torch`` once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. The cells, configurations, traffic drivers and
metrics are files found by name (``harness/spec.py``); this file only
dispatches to ``harness/cli.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import cli  # noqa: E402

if __name__ == "__main__":
    cli.main()
