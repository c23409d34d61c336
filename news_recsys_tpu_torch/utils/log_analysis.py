"""Experiment-log analyzer: parse ``val_log.log``, report the best epoch.

The port's own copy of :mod:`news_recsys_tpu.utils.log_analysis` (standard
library only; ``tests/test_torch_shared.py`` holds it to the original).
Capability parity with the reference's ``src/scripts/log_analysis.py``
(best epoch by Warm-Start AUC, markdown report): the parser inverts the
block format that :func:`news_recsys_tpu_torch.training.metrics.
format_validation_block` (and the DSSM's ``Retrieval:`` block) emits, and
the report is rendered by a generic markdown-table helper over the parsed
section dicts.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List, Optional

# Inverses of format_validation_block's emissions (metrics.py:189-215) and
# the Retrieval block (retrieval.py): an epoch header, a section header
# ("Overall:", "Warm Start Users (123):", "Retrieval ..."), a metric line.
EPOCH_HEADER = re.compile(r"=+ Epoch (\d+) Validation Results =+")
SECTION_HEADER = re.compile(r"^(?P<name>[A-Za-z][A-Za-z @]*?)\s*(?:\([^)]*\))?\s*:\s*$")
METRIC_LINE = re.compile(r"^\s+(?P<name>[A-Za-z0-9@]+):\s+(?P<value>\S+)\s*$")

# canonical section keys, in report column order
SECTIONS = ["Overall", "Warm Start Users", "Cold Start Users"]


def _canon_section(raw: str) -> str:
    for key in (*SECTIONS, "Retrieval"):
        if raw.startswith(key.split()[0]):
            return key
    return raw


def _parse_block(text: str) -> Dict[str, Dict[str, float]]:
    """One epoch block -> {section: {metric: value}}."""
    sections: Dict[str, Dict[str, float]] = {}
    current: Optional[Dict[str, float]] = None
    for line in text.splitlines():
        if SECTION_HEADER.match(line):
            current = sections.setdefault(
                _canon_section(SECTION_HEADER.match(line)["name"]), {})
            continue
        m = METRIC_LINE.match(line)
        if m and current is not None:
            try:
                current[m["name"]] = float(m["value"])
            except ValueError:
                current[m["name"]] = float("nan")
    return sections


def parse_log(file_path: str) -> List[Dict]:
    """Parse a ``val_log.log`` into ``[{"epoch": int, "data": {...}}, ...]``."""
    with open(file_path, "r") as f:
        # split on epoch headers; parts alternate [junk, epoch#, block, ...]
        parts = EPOCH_HEADER.split(f.read())
    return [{"epoch": int(num), "data": _parse_block(body)}
            for num, body in zip(parts[1::2], parts[2::2])]


def _retrieval_criterion(e: Dict) -> Optional[float]:
    """Primary retrieval metric: the smallest-k HR@k present."""
    sec = e.get("data", {}).get("Retrieval", {})
    hrs = sorted((int(name.split("@")[1]), v) for name, v in sec.items()
                 if name.startswith("HR@"))
    return hrs[0][1] if hrs else None


def best_epoch(epochs: List[Dict]) -> Optional[Dict]:
    """Best epoch by Warm-Start AUC (the reference's selection criterion,
    ``log_analysis.py:86-98``); retrieval runs (DSSM val_log blocks) fall
    back to HR@k."""

    def criterion(e: Dict) -> float:
        val = e.get("data", {}).get("Warm Start Users", {}).get("AUC")
        if val is None:
            val = _retrieval_criterion(e)
        return val if val is not None and val == val else float("-inf")

    candidates = [e for e in epochs if criterion(e) > float("-inf")]
    return max(candidates, key=criterion) if candidates else None


def _md_table(headers: List[str], rows: List[List[str]]) -> str:
    lines = ["| " + " | ".join(headers) + " |",
             "| " + " | ".join(["---"] * len(headers)) + " |"]
    lines += ["| " + " | ".join(row) + " |" for row in rows]
    return "\n".join(lines)


def _fmt(val, metric: str = "") -> str:
    if not isinstance(val, float):
        return str(val)
    if metric in ("Queries", "User_Count") or val == int(val) and abs(val) >= 100:
        return str(int(val))
    return f"{val:.4f}"


def format_best_epoch(epochs: List[Dict], model_name: str = "Unknown") -> str:
    e = best_epoch(epochs)
    if not e:
        return "No valid epoch data found."
    data = e["data"]
    if "Retrieval" in data and "Warm Start Users" not in data:
        sec = data["Retrieval"]
        title = (f"## {model_name} — Best Epoch {e['epoch']} "
                 f"(Retrieval HR: {_retrieval_criterion(e):.4f})")
        rows = [[metric, _fmt(val, metric)] for metric, val in sorted(sec.items())]
        return f"{title}\n\n" + _md_table(["Metric", "Value"], rows)
    title = (f"## {model_name} — Best Epoch {e['epoch']} "
             f"(Warm Start AUC: {data['Warm Start Users']['AUC']:.4f})")
    present = [s for s in SECTIONS if s in data]
    metrics: List[str] = []
    for s in present:  # union, first-seen order
        metrics += [m for m in data[s] if m not in metrics]
    rows = [[metric] + [_fmt(data[s].get(metric, "N/A"), metric) for s in present]
            for metric in metrics]
    return f"{title}\n\n" + _md_table(["Metric"] + present, rows)


def model_name_from_dir(log_file: str) -> str:
    """Experiment dirs are ``experiments/<model>_<YYYYmmdd-HHMMSS>``; strip
    the trailing timestamp if present, else use the dir name as-is."""
    dirname = os.path.basename(os.path.dirname(os.path.abspath(log_file)))
    return re.sub(r"_\d{8}-\d{6}$", "", dirname) or "Unknown"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Report the best epoch of a val_log.log as markdown.")
    parser.add_argument("log_file")
    args = parser.parse_args(argv)
    if not os.path.exists(args.log_file):
        print(f"Log file not found: {args.log_file}")
        return
    print(format_best_epoch(parse_log(args.log_file),
                            model_name_from_dir(args.log_file)))


if __name__ == "__main__":
    main()
