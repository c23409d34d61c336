"""Closed-loop serving, as a job that precomputes feeds: one client sends
``POST /recommend`` requests of ``users`` users each (k 10, fetch 100) and
waits for each reply before it sends the next, over loopback to the port's
HTTP server, until the window closes.

``serve_users_per_s`` is the users answered over the window's wall time,
from its start to the last reply.
"""

from __future__ import annotations

from harness import serving


def run(ctx) -> None:
    records = serving.run(ctx)
    serving.generator_health(records)
    ok = [r for r in records["records"] if r[3] == 200]
    wall = max(r[2] for r in ok)
    ctx.e2e["serve_users_per_s"] = len(ok) * ctx.params["users"] / wall
    ctx.attempted, ctx.failed = len(records["records"]), len(records["records"]) - len(ok)
