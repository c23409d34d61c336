"""Command line of the PyTorch port: ``python -m news_recsys_tpu_torch serve``.

``serve`` loads a bundle of this package (a recall bundle or a cascade
bundle; ``scripts/export_torch_bundle.py`` converts the JAX package's
bundles) and serves it over HTTP on ``--device`` (default ``cuda``). A CUDA
device that is not there is an error, not a reason to serve on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def cmd_serve(args) -> None:
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA GPU is visible "
                         "(torch.cuda.is_available() is False); pass --device cpu "
                         "to serve with the plain PyTorch ops")
    from .serving import CascadeRecommender, Recommender, serve_http

    with open(os.path.join(args.bundle, "meta.json")) as f:
        is_cascade = json.load(f).get("kind") == "cascade"
    if is_cascade:
        rec = CascadeRecommender.load(args.bundle, device=args.device,
                                      fetch=args.fetch or None)
    else:
        rec = Recommender.load(args.bundle, device=args.device)
    server = serve_http(rec, host=args.host, port=args.port)
    print(f"Serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="news_recsys_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="serve a recall or cascade bundle over HTTP")
    s.add_argument("--bundle", required=True, help="bundle directory of this package")
    s.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8321)
    s.add_argument("--fetch", type=int, default=0,
                   help="cascade candidates per user (0: the bundle's own)")
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
