"""The load generator: a process of its own (numpy and the standard library,
no torch), so that it shares no interpreter lock with the server.

Run as ``python3 http_client.py <spec.json>``. It makes the requests of the
spec's seed (:mod:`harness.inputs`), encodes every body, sends the
``warmup`` requests one after another, prints ``WARM`` and waits for a line
``GO <t0>`` (``time.perf_counter`` seconds, the window's start). Then it
sends one request after another until ``t0 + seconds``, each when the last
was answered, through the ``requests`` bodies in turn (request i sends body
i mod n).

It waits for the answers up to ``grace`` seconds past the window's close,
writes ``out``: one record ``[i, sent, done, status]`` a request (done
None where no answer came) and the bodies of the answers to ``save``, and
prints ``DONE``.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import inputs  # noqa: E402


def send(host: str, port: int, body: bytes, deadline: float) -> tuple:
    """(status, reply bytes, done time); status 0 where no answer came."""
    try:
        conn = http.client.HTTPConnection(host, port,
                                          timeout=max(1.0, deadline - time.perf_counter()))
        try:
            conn.request("POST", "/recommend", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data, time.perf_counter()
        finally:
            conn.close()
    except OSError:
        return 0, b"", None


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    host, port, n = spec["host"], spec["port"], spec["requests"]
    world = inputs.World(spec["config"], spec["seed"], spec["law"])
    reqs = inputs.requests(world, spec["config"], spec["seed"], n + spec["warmup"],
                           spec["users"])
    del world
    bodies = [inputs.body(reqs, i, spec["k"]) for i in range(n + spec["warmup"])]
    statuses = [send(host, port, b, time.perf_counter() + 600)[0] for b in bodies[n:]]
    if any(s != 200 for s in statuses):
        raise SystemExit(f"warm-up requests answered {statuses}")
    print("WARM", flush=True)
    line = sys.stdin.readline().split()
    if not line or line[0] != "GO":
        raise SystemExit(f"expected GO, got {line}")
    t0 = float(line[1])
    end, deadline = t0 + spec["seconds"], t0 + spec["seconds"] + spec["grace"]
    save = set(spec["save"])
    records, saved = [], {}
    i = 0
    while time.perf_counter() < end:
        sent = time.perf_counter()
        status, data, done = send(host, port, bodies[i % n], deadline)
        records.append([i, sent - t0, None if done is None else done - t0, status])
        if i in save and status == 200:
            saved[str(i)] = data.decode()
        i += 1
    with open(spec["out"], "w") as f:
        json.dump({"records": sorted(records), "saved": saved}, f)
    print("DONE", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
