"""repro_torch.union.serve — simulation-as-a-service on the port's engine.

One hot process, many clients: a stdlib-only REST service
(``http.server.ThreadingHTTPServer``, no new dependencies) in front of
the port's Experiment facade. Submitted experiments queue through a
single background worker that calls :func:`repro_torch.union.run` on the
server's device (CUDA unless the server is made with ``device="cpu"``)
against the long-lived **process-wide engine cache** — so every
experiment after the first with a given engine envelope is warm, its
CUDA graphs captured — and the content-hash **experiment store**
(:mod:`repro_torch.union.store`) — so identical cells are never simulated
twice, across submissions *and* server restarts. The REST surface is the
JAX package's ``repro.union.serve``'s.

Control surface (see ``docs/serve.md``)::

    POST /experiments                # Experiment JSON -> 202 {"id": ...}
    GET  /experiments                # all jobs, newest first
    GET  /experiments/<id>           # queued|running|done|error|cancelled
                                     #  + cells completed / total
    GET  /experiments/<id>/results   # the Results artifact (done jobs)
    POST /experiments/<id>/cancel    # cooperative cancel between plan nodes
    GET  /metrics                    # OpenMetrics text (repro_torch.obs)
    GET  /healthz                    # engine cache, store, queue stats

Run it::

    python -m repro_torch.union.serve --port 8642 --store results/store

and talk to it with :mod:`repro_torch.union.client` (``ServeClient`` /
``submit_and_wait``). It binds ``127.0.0.1`` unless told otherwise.

Not to be confused with :mod:`repro_torch.launch.serve`, which is the **LM
token-decoding** serving driver (continuous-batching inference slots for
the model stack) — this module serves *network-simulation experiments*.
"""
from repro_torch.union.serve.server import (  # noqa: F401
    Job,
    JobManager,
    UnionServer,
    make_server,
)

__all__ = ["Job", "JobManager", "UnionServer", "make_server"]
