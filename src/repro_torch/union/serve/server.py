"""The Union server: job manager + HTTP layer (stdlib only).

Split in two so tests and benchmarks can drive either level:

* :class:`JobManager` — the service core. A thread-safe submission queue
  drained by **one** background worker thread calling
  :func:`repro_torch.union.run` on the manager's device: simulation stays
  serialized (one hot engine cache, one thread on the card, no device
  contention) while the HTTP layer stays fully concurrent. Jobs move
  ``queued -> running -> done|error|cancelled``;
  cancellation is cooperative — a flag polled by the facade between plan
  nodes, mirroring the virtualoffice ``advance-and-tick`` status/cancel
  control surface.
* :class:`UnionServer`/:func:`make_server` — a ``ThreadingHTTPServer``
  routing the REST surface onto a manager.

Progress reporting rides the metrics registry: the worker snapshots
``union_cells_completed`` (counted by the facade) when a job starts, and
status reads report the delta — no extra plumbing through the facade.
"""
from __future__ import annotations

import json
import queue
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs import get_registry, log
from repro_torch.union import experiment as EXP
from repro_torch.union import planner as PLN
from repro_torch.union.store import ExperimentStore
from repro_torch.union.validate import SpecError

# terminal states: no further transitions
TERMINAL = ("done", "error", "cancelled")


class Job:
    """One submitted experiment and its lifecycle state."""

    def __init__(self, job_id: str, spec: Dict[str, Any],
                 experiment: EXP.Experiment):
        self.id = job_id
        self.spec = spec
        self.experiment = experiment
        self.status = "queued"
        self.error: Optional[str] = None
        self.results: Optional[EXP.Results] = None
        self.cancel = threading.Event()
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.cells_total: Optional[int] = None
        self._cells_base = 0.0  # union_cells_completed at job start

    def summary(self, manager: "JobManager") -> Dict[str, Any]:
        """The status JSON for ``GET /experiments/<id>``."""
        d: Dict[str, Any] = dict(
            id=self.id,
            name=self.experiment.name,
            status=self.status,
            submitted_at=self.submitted_at,
            started_at=self.started_at,
            finished_at=self.finished_at,
            cells_total=self.cells_total,
            cells_completed=self.cells_completed(manager),
        )
        if self.error is not None:
            d["error"] = self.error
        if self.results is not None:
            d["wall_s"] = self.results.wall_s
            d["engine_cache"] = dict(self.results.engine_cache)
            d["store"] = dict(self.results.telemetry.get("store") or {})
        return d

    def cells_completed(self, manager: "JobManager") -> int:
        if self.results is not None:
            return len(self.results.cells)
        if self.status != "running":
            return 0
        ctr = get_registry().counter(
            "union_cells_completed", "experiment cells executed")
        return int(ctr.value() - self._cells_base)


class JobManager:
    """Submission queue + single worker + job table (thread-safe).

    ``store`` (path or :class:`ExperimentStore`) is consulted for every
    cell of every job; ``cache_max`` caps the process-wide engine cache
    (LRU) so a long-running server is memory-bounded. ``device`` is where
    the worker runs every job (CUDA by default; ``"cpu"`` runs the
    engine's CPU path). ``node_hook`` is a test-only seam invoked (with
    the job) every time the facade polls for cancellation between plan
    nodes.
    """

    def __init__(self, store: Optional[Any] = None,
                 cache_max: Optional[int] = None,
                 node_hook: Optional[Callable[[Job], None]] = None,
                 device=None):
        if isinstance(store, str):
            store = ExperimentStore(store)
        self.store = store
        self.node_hook = node_hook
        self.device = device
        if cache_max is not None:
            from repro_torch.netsim.engine import set_engine_cache_limit

            set_engine_cache_limit(cache_max)
        self._jobs: Dict[str, Job] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._n = 0
        self._worker = threading.Thread(
            target=self._run_loop, name="union-serve-worker", daemon=True)
        self._worker.start()

    # ---- client-facing operations ------------------------------------
    def submit(self, spec: Dict[str, Any]) -> Job:
        """Validate + enqueue one experiment spec. Raises
        :class:`~repro_torch.union.validate.SpecError` on a bad spec."""
        if isinstance(spec, dict) and isinstance(spec.get("experiment"),
                                                 dict):
            spec = spec["experiment"]  # accept the wrapped form too
        exp = EXP.Experiment.from_dict(spec)
        with self._lock:
            self._n += 1
            job_id = f"exp-{self._n:04d}-{uuid.uuid4().hex[:8]}"
            job = Job(job_id, spec, exp)
            self._jobs[job_id] = job
            self._order.append(job_id)
        self._queue.put(job_id)
        self._gauge_queue()
        log.info("serve: queued %s (%s)", job_id, exp.name)
        return job

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> List[Job]:
        """All jobs, newest first."""
        with self._lock:
            return [self._jobs[i] for i in reversed(self._order)]

    def cancel(self, job_id: str) -> Optional[Job]:
        """Request cancellation: queued jobs never start, running jobs
        stop at the next plan-node boundary, terminal jobs are left
        untouched (idempotent)."""
        job = self.get(job_id)
        if job is None:
            return None
        job.cancel.set()
        with self._lock:
            if job.status == "queued":
                self._finish(job, "cancelled")
        return job

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the worker after the current job (tests/shutdown)."""
        self._queue.put(None)
        self._worker.join(timeout=timeout)

    # ---- the worker --------------------------------------------------
    def _run_loop(self) -> None:
        while True:
            job_id = self._queue.get()
            if job_id is None:
                return
            self._gauge_queue()
            job = self.get(job_id)
            if job is None or job.status != "queued":
                continue  # cancelled while queued
            self._execute(job)

    def _execute(self, job: Job) -> None:
        job.status = "running"
        job.started_at = time.time()
        ctr = get_registry().counter(
            "union_cells_completed", "experiment cells executed")
        job._cells_base = ctr.value()
        log.info("serve: running %s (%s)", job.id, job.experiment.name)
        try:
            plan = PLN.plan(job.experiment)
            job.cells_total = plan.total_cells
            job.results = EXP.run(
                job.experiment, plan=plan, store=self.store,
                cancel=self._cancel_cb(job), device=self.device)
            self._finish(job, "done")
        except EXP.RunCancelled:
            self._finish(job, "cancelled")
        except Exception as e:  # a failed job must not kill the worker
            job.error = f"{type(e).__name__}: {e}"
            self._finish(job, "error")
            log.warning("serve: %s failed: %s", job.id, job.error)

    def _cancel_cb(self, job: Job) -> Callable[[], bool]:
        hook = self.node_hook

        def cb() -> bool:
            if hook is not None:
                hook(job)
            return job.cancel.is_set()

        return cb

    def _finish(self, job: Job, status: str) -> None:
        job.status = status
        job.finished_at = time.time()
        get_registry().counter(
            "union_serve_jobs", "server jobs by terminal status").inc(
            status=status)
        log.info("serve: %s -> %s", job.id, status)

    def _gauge_queue(self) -> None:
        get_registry().gauge(
            "union_serve_queue_depth", "experiments waiting to run").set(
            self._queue.qsize())


# ---------------------------------------------------------------------------
# the HTTP layer
# ---------------------------------------------------------------------------

_ID = r"(?P<id>[A-Za-z0-9_.-]+)"
_ROUTES = [
    ("POST", re.compile(r"^/experiments/?$"), "submit"),
    ("GET", re.compile(r"^/experiments/?$"), "list"),
    ("GET", re.compile(rf"^/experiments/{_ID}$"), "status"),
    ("GET", re.compile(rf"^/experiments/{_ID}/results$"), "results"),
    ("POST", re.compile(rf"^/experiments/{_ID}/cancel$"), "cancel"),
    ("GET", re.compile(r"^/metrics$"), "metrics"),
    ("GET", re.compile(r"^/healthz$"), "health"),
    ("GET", re.compile(r"^/$"), "index"),
]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "union-serve"

    # ---- plumbing ----------------------------------------------------
    @property
    def manager(self) -> JobManager:
        return self.server.manager  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # route access logs through obs
        log.debug("serve: %s", fmt % args)

    def _send_json(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload, default=float).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        # stream in chunks: metrics and results payloads can be large
        for i in range(0, len(body), 64 * 1024):
            self.wfile.write(body[i:i + 64 * 1024])

    def _read_body(self) -> Any:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if not raw:
            return None
        return json.loads(raw)

    def _dispatch(self, method: str) -> None:
        path = self.path.split("?", 1)[0]
        path_matched = False
        for verb, pat, name in _ROUTES:
            m = pat.match(path)
            if m is None:
                continue
            path_matched = True
            if verb != method:
                continue  # same path under another verb may still match
            get_registry().counter(
                "union_serve_requests", "HTTP requests by route").inc(
                route=name)
            try:
                getattr(self, f"_do_{name}")(**m.groupdict())
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                self._send_json(400, dict(error=f"bad JSON body: {e}"))
            except SpecError as e:
                self._send_json(400, dict(error=str(e)))
            except BrokenPipeError:
                pass  # client went away mid-response
            except Exception as e:
                log.warning("serve: %s %s -> 500 %s", method, path, e)
                self._send_json(500, dict(
                    error=f"{type(e).__name__}: {e}"))
            return
        if path_matched:
            self._send_json(405, dict(
                error=f"{method} not allowed on {path}"))
        else:
            self._send_json(404, dict(error=f"no route {method} {path}"))

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    # ---- routes ------------------------------------------------------
    def _do_submit(self) -> None:
        spec = self._read_body()
        if not isinstance(spec, dict):
            self._send_json(400, dict(
                error="body must be an Experiment JSON object"))
            return
        job = self.manager.submit(spec)
        self._send_json(202, dict(
            id=job.id, status=job.status,
            url=f"/experiments/{job.id}"))

    def _do_list(self) -> None:
        self._send_json(200, dict(jobs=[
            j.summary(self.manager) for j in self.manager.jobs()]))

    def _job_or_404(self, job_id: str) -> Optional[Job]:
        job = self.manager.get(job_id)
        if job is None:
            self._send_json(404, dict(error=f"unknown job {job_id!r}"))
        return job

    def _do_status(self, id: str) -> None:
        job = self._job_or_404(id)
        if job is not None:
            self._send_json(200, job.summary(self.manager))

    def _do_results(self, id: str) -> None:
        job = self._job_or_404(id)
        if job is None:
            return
        if job.status != "done" or job.results is None:
            self._send_json(409, dict(
                id=job.id, status=job.status, error=(
                    f"job {job.id} is {job.status}; results require"
                    " status 'done'")))
            return
        self._send_text(
            200, json.dumps(job.results.to_dict(), default=float),
            "application/json")

    def _do_cancel(self, id: str) -> None:
        job = self.manager.cancel(id)
        if job is None:
            self._send_json(404, dict(error=f"unknown job {id!r}"))
            return
        self._send_json(200, dict(id=job.id, status=job.status,
                                  cancel_requested=True))

    def _do_metrics(self) -> None:
        self._send_text(
            200, get_registry().render_openmetrics(),
            "application/openmetrics-text; version=1.0.0; charset=utf-8")

    def _do_health(self) -> None:
        from repro_torch.netsim.engine import engine_cache_stats

        mgr = self.manager
        jobs = mgr.jobs()
        self._send_json(200, dict(
            status="ok",
            engine_cache=engine_cache_stats(),
            store=(mgr.store.stats() if mgr.store is not None else None),
            jobs={s: sum(1 for j in jobs if j.status == s)
                  for s in ("queued", "running") + TERMINAL},
        ))

    def _do_index(self) -> None:
        self._send_json(200, dict(
            service="repro_torch.union.serve",
            doc="docs/serve.md",
            endpoints=[f"{verb} {pat.pattern}"
                       for verb, pat, _ in _ROUTES],
        ))


class UnionServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer that owns a :class:`JobManager`."""

    daemon_threads = True

    def __init__(self, addr, manager: JobManager):
        super().__init__(addr, _Handler)
        self.manager = manager

    @property
    def port(self) -> int:
        return self.server_address[1]

    def close(self) -> None:
        """Stop accepting, then stop the worker (current job finishes)."""
        self.shutdown()
        self.server_close()
        self.manager.stop()


def make_server(host: str = "127.0.0.1", port: int = 0,
                store: Optional[Any] = None,
                cache_max: Optional[int] = None,
                node_hook: Optional[Callable[[Job], None]] = None,
                device=None) -> UnionServer:
    """Bind a Union server (``port=0`` picks an ephemeral port; read it
    back from ``server.port``) whose worker runs on ``device``. Call
    ``serve_forever()`` on it — tests run that in a thread — and
    ``close()`` to tear down."""
    return UnionServer((host, port), JobManager(
        store=store, cache_max=cache_max, node_hook=node_hook,
        device=device))
