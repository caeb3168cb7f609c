"""``python -m repro_torch.union.serve`` — run the port's Union server.

Examples::

    # bounded engine cache + a persistent store next to the results
    python -m repro_torch.union.serve --port 8642 --store results/store

    # ephemeral store-less server on a random port (prints the URL)
    python -m repro_torch.union.serve --port 0
"""
from __future__ import annotations

import argparse

from repro_torch import obs
from repro_torch.union.serve.server import make_server


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.union.serve",
        description="Union simulation server: POST Experiment specs, the"
        " warm engine cache + content-hash store make every repeat"
        " cheap (docs/serve.md). Not the LM decode server — that is"
        " python -m repro_torch.launch.serve.",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642,
                    help="listen port (0 = pick an ephemeral port)")
    ap.add_argument("--store", metavar="DIR", default=None,
                    help="content-hash experiment store directory;"
                    " identical cells are never simulated twice, across"
                    " submissions and server restarts")
    ap.add_argument("--cache-max", type=int, default=16, metavar="N",
                    help="LRU cap on the process-wide engine cache"
                    " (default 16; 0 = unbounded)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the worker runs on (default cuda;"
                    " cpu runs the engine's CPU path)")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="diagnostic logging (-v info, -vv debug)")
    args = ap.parse_args(argv)
    obs.set_verbosity(max(args.verbose, 1))  # a server should say hello

    server = make_server(
        host=args.host, port=args.port, store=args.store,
        cache_max=args.cache_max or None, device=args.device)
    obs.log.info(
        "union server listening on http://%s:%d (store=%s, cache_max=%s)",
        args.host, server.port, args.store or "<none>",
        args.cache_max or "unbounded")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        obs.log.info("union server shutting down")
        server.close()


if __name__ == "__main__":
    main()
