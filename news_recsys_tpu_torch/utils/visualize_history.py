"""Interactive HTML report of per-user impression history.

The port's version of :mod:`news_recsys_tpu.utils.visualize_history`, on
numpy and the standard library (the original reads through pandas, which
the port does not depend on); on the same raw files it writes the same page,
byte for byte (``tests/test_torch_tooling.py``). Capability parity with the
reference's ``src/scripts/visiualize_user_history.py``: loads raw MIND
``news.tsv`` / ``behaviors.tsv``, groups impressions per user sorted by
time, and emits a self-contained HTML page (user list -> impression
timeline -> history vs clicked/unclicked candidates). What pandas did to
the files is kept (:func:`..data.preprocess.read_tsv`): a missing field
or one of pandas' NA strings reads as ``nan``, and impressions are ordered
by numpy's quicksort on the parsed times, as ``sort_values`` runs it, so
tied times come in the order that sort gives.
"""

from __future__ import annotations

import argparse
import html
import json
from typing import Dict, List, Optional

from ..data.preprocess import BEHAVIOR_COLS, NEWS_COLS, parse_times, read_tsv
from .logging import get_logger

logger = get_logger("visualize_history")

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>User History Visualizer</title>
<style>
 body {{ font-family: sans-serif; margin: 0; display: flex; height: 100vh; }}
 #users {{ width: 220px; overflow-y: auto; border-right: 1px solid #ccc; padding: 8px; }}
 #main {{ flex: 1; overflow-y: auto; padding: 16px; }}
 .user {{ cursor: pointer; padding: 4px 8px; border-radius: 4px; }}
 .user:hover, .user.active {{ background: #e0ecff; }}
 .impression {{ border: 1px solid #ddd; border-radius: 6px; margin: 12px 0; padding: 10px; }}
 .impression h4 {{ margin: 0 0 6px 0; }}
 .item {{ display: inline-block; margin: 2px; padding: 2px 8px; border-radius: 10px;
          background: #f0f0f0; font-size: 13px; }}
 .clicked {{ background: #c8f7c5; }}
 .unclicked {{ background: #fad7d7; }}
 .hist {{ background: #dde6ff; }}
 .cat {{ color: #666; font-size: 11px; }}
</style></head><body>
<div id="users"><h3>Users ({n_users})</h3>{user_list}</div>
<div id="main"><p>Select a user.</p></div>
<script>
const DATA = {data_json};
function show(uid, el) {{
  document.querySelectorAll('.user').forEach(e => e.classList.remove('active'));
  el.classList.add('active');
  const imps = DATA[uid];
  let out = `<h2>User ${{uid}} — ${{imps.length}} impressions</h2>`;
  for (const imp of imps) {{
    out += `<div class="impression"><h4>${{imp.time}}</h4>`;
    out += `<div><b>History:</b> ` + imp.history.map(h =>
      `<span class="item hist">${{h.title}}<span class="cat"> ${{h.category}}</span></span>`).join('') + `</div>`;
    out += `<div><b>Candidates:</b> ` + imp.candidates.map(c =>
      `<span class="item ${{c.clicked ? 'clicked' : 'unclicked'}}">${{c.title}}<span class="cat"> ${{c.category}}</span></span>`).join('') + `</div>`;
    out += `</div>`;
  }}
  document.getElementById('main').innerHTML = out;
}}
</script></body></html>
"""


def _text(value: Optional[str]) -> str:
    """A field as ``str()`` of its pandas cell gives it: missing is ``nan``."""
    return "nan" if value is None else value


def load_news_data(path: str) -> Dict[str, Dict[str, str]]:
    return {_text(r[0]): {"title": _text(r[3]), "category": _text(r[1])}
            for r in read_tsv(path, len(NEWS_COLS))}


def load_behaviors_data(path: str) -> List[List[Optional[str]]]:
    """The behaviors rows (impression id, user, time, history, impressions)
    in time order."""
    rows = read_tsv(path, len(BEHAVIOR_COLS))
    order = parse_times([r[2] for r in rows]).argsort(kind="quicksort")   # as sort_values
    return [rows[i] for i in order]


def generate_html_report(news_path: str, behaviors_path: str, output_path: str,
                         max_users: int = 200) -> str:
    news = load_news_data(news_path)
    beh = load_behaviors_data(behaviors_path)

    def info(nid: str) -> Dict[str, str]:
        d = news.get(nid, {"title": nid, "category": "?"})
        return {"title": html.escape(d["title"][:60]), "category": html.escape(d["category"])}

    data: Dict[str, List[dict]] = {}
    for _, user_id, time, history, impressions in beh:
        uid = _text(user_id)
        if uid not in data and len(data) >= max_users:
            continue
        hist = [info(h) for h in history.split(" ")[:30]] if history is not None else []
        cands = []
        for tok in _text(impressions).split(" "):
            if "-" not in tok:
                continue
            nid, label = tok.rsplit("-", 1)
            cands.append({**info(nid), "clicked": label == "1"})
        data.setdefault(uid, []).append({"time": _text(time), "history": hist,
                                         "candidates": cands})

    user_list = "".join(
        f'<div class="user" onclick="show({json.dumps(u)}, this)">{html.escape(u)} '
        f'({len(v)})</div>' for u, v in data.items()
    )
    page = _PAGE.format(n_users=len(data), user_list=user_list,
                        data_json=json.dumps(data))
    with open(output_path, "w", encoding="utf-8") as f:
        f.write(page)
    logger.info(f"Wrote {output_path}: {len(data)} users")
    return output_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize user impression history")
    parser.add_argument("--news", required=True)
    parser.add_argument("--behaviors", required=True)
    parser.add_argument("--output", default="user_history_report.html")
    parser.add_argument("--max-users", type=int, default=200)
    args = parser.parse_args(argv)
    generate_html_report(args.news, args.behaviors, args.output, args.max_users)


if __name__ == "__main__":
    main()
