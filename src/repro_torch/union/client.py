"""Thin stdlib client for the port's Union server
(:mod:`repro_torch.union.serve`).

``ServeClient`` wraps the REST surface with submit/wait/fetch helpers —
the same calls the server lifecycle tests and ``chip_smoke.py`` drive;
it speaks the JAX package's REST surface, so it talks to either
package's server::

    from repro_torch.union.client import ServeClient

    c = ServeClient("http://127.0.0.1:8642")
    job_id = c.submit("examples/experiments/smoke.json")
    c.wait(job_id)                      # poll until terminal
    results = c.results(job_id)         # a repro_torch.union.Results
    print(results.summary["trace_studies"])

``urllib.request`` only — no new dependencies anywhere in the serving
stack.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Union as TUnion

from repro_torch.union import experiment as EXP


class ServeError(RuntimeError):
    """A non-2xx server response, with the decoded error payload."""

    def __init__(self, status: int, payload: Any):
        msg = payload.get("error") if isinstance(payload, dict) else payload
        super().__init__(f"HTTP {status}: {msg}")
        self.status = status
        self.payload = payload


class ServeClient:
    """Submit/wait/fetch against one Union server base URL."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ---- transport ---------------------------------------------------
    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None) -> Any:
        data = (json.dumps(body, default=float).encode("utf-8")
                if body is not None else None)
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                raw = r.read()
                ctype = r.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                payload = json.loads(raw)
            except ValueError:
                payload = raw.decode("utf-8", "replace")
            raise ServeError(e.code, payload) from None
        if ctype.startswith("application/json"):
            return json.loads(raw)
        return raw.decode("utf-8")

    # ---- the surface -------------------------------------------------
    def submit(self,
               experiment: TUnion[EXP.Experiment, Dict[str, Any], str],
               ) -> str:
        """POST an experiment (an :class:`Experiment`, a spec dict, or a
        JSON file path) and return the job id (HTTP 202)."""
        if isinstance(experiment, str):
            experiment = EXP.load_experiment(experiment)
        if isinstance(experiment, EXP.Experiment):
            experiment = experiment.to_dict()
        return self._request("POST", "/experiments", body=experiment)["id"]

    def status(self, job_id: str) -> Dict[str, Any]:
        return self._request("GET", f"/experiments/{job_id}")

    def jobs(self) -> Dict[str, Any]:
        return self._request("GET", "/experiments")

    def cancel(self, job_id: str) -> Dict[str, Any]:
        return self._request("POST", f"/experiments/{job_id}/cancel")

    def wait(self, job_id: str, timeout: float = 600.0,
             poll_s: float = 0.2) -> Dict[str, Any]:
        """Poll status until the job is terminal (done/error/cancelled);
        returns the final status payload or raises ``TimeoutError``."""
        deadline = time.time() + timeout
        while True:
            st = self.status(job_id)
            if st["status"] in ("done", "error", "cancelled"):
                return st
            if time.time() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {st['status']} after {timeout}s "
                    f"({st.get('cells_completed')}/{st.get('cells_total')}"
                    " cells)")
            time.sleep(poll_s)

    def results(self, job_id: str) -> EXP.Results:
        """The finished job's Results (409 -> ServeError otherwise)."""
        raw = self._request("GET", f"/experiments/{job_id}/results")
        if isinstance(raw, str):  # defensively accept text payloads
            raw = json.loads(raw)
        return EXP.Results.from_dict(raw)

    def metrics(self) -> str:
        """The server's OpenMetrics exposition text."""
        return self._request("GET", "/metrics")

    def health(self) -> Dict[str, Any]:
        return self._request("GET", "/healthz")


def submit_and_wait(base_url: str, experiment,
                    timeout: float = 600.0) -> EXP.Results:
    """One-shot convenience: submit, wait, fetch Results (raises
    :class:`ServeError`/``RuntimeError`` on error/cancel)."""
    c = ServeClient(base_url)
    job_id = c.submit(experiment)
    st = c.wait(job_id, timeout=timeout)
    if st["status"] != "done":
        raise RuntimeError(
            f"job {job_id} finished {st['status']}: {st.get('error')}")
    return c.results(job_id)
