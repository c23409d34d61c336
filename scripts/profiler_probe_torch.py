"""Which first ``torch.profiler`` session makes later sessions of a process
lose their kernels, on the card: 8 sessions in a row, each tracing one FM
forward (B 1, 5 x 15), with the kernel library built (into a fresh
directory) inside the first session or before it:

    build_in   the build inside the first session
    build_out  the build before it (as the GPU tests' ``profiler_ready`` does)

    KINETO_LOG_LEVEL=0 python scripts/profiler_probe_torch.py MODE OUT_PREFIX

Prints one JSON line: the kernels each session's trace holds and each
session's wall seconds. With ``KINETO_LOG_LEVEL=0`` Kineto prints each
session's "Record counts" (its ``Out-of-range`` count) on stderr.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

MODES = ("build_in", "build_out")
SESSIONS = 8


def main(argv=None) -> dict:
    from news_recsys_tpu_torch.ops import _build
    from news_recsys_tpu_torch.ops.fm_kernel import fm_second_order

    mode, out = (argv or sys.argv[1:])[:2]
    if mode not in MODES:
        raise SystemExit(f"mode {mode!r}: one of {MODES}")
    _build.BUILD_DIR = Path(tempfile.mkdtemp())        # a fresh build
    t_start = time.time()
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 5, 15))
                         .astype(np.float32)).to("cuda")
    torch.cuda.synchronize()

    if mode == "build_out":
        _build.library()
        fm_second_order(v)
        torch.cuda.synchronize()

    rows = []
    for i in range(SESSIONS):
        t0 = time.time()
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            if i == 0 and mode == "build_in":
                _build.library()
            fm_second_order(v)
            torch.cuda.synchronize()
        path = f"{out}_{i}.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        os.remove(path)
        rows.append({"i": i, "t": round(time.time() - t_start, 2),
                     "dur": round(time.time() - t0, 2), "kernels": len(kernels)})
    result = {"mode": mode, "kernels": [r["kernels"] for r in rows], "rows": rows}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
