"""The port's Union server lifecycle, end to end over real HTTP on
``127.0.0.1``, against the JAX package's server.

``tests/test_serve.py``'s seven cases on ``repro_torch.union.serve`` (its
worker on the CPU): submit the smoke experiment to an in-thread server on
an ephemeral port, poll to done, fetch Results — equal, cell for cell, to
what the JAX package's server returns for the same spec — then re-submit
and get a pure store replay (0 cells simulated, the same cells);
concurrent submissions; the one-shot helper; health and metrics;
cooperative cancellation (running and queued); the error codes; the
index. The port's client drives both servers: the REST surface is one.
"""
import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

from repro import union as REF
from repro.union.serve import make_server as ref_make_server
from repro_torch import union
from repro_torch.union.client import ServeClient, ServeError, submit_and_wait
from repro_torch.union.serve import make_server
from torch_parity import assert_cells_match

SMOKE = os.path.join(os.path.dirname(__file__), os.pardir,
                     "examples", "experiments", "smoke.json")

PP = (
    "For 4 repetitions {\n"
    " task 0 sends a 1024 byte message to task 1 then\n"
    " task 1 sends a 1024 byte message to task 0 }"
)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serving(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = serving(make_server(store=str(tmp_path_factory.mktemp("store")),
                              device="cpu"))
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def client(server):
    return ServeClient(f"http://127.0.0.1:{server.port}")


def tiny_experiment(**kw):
    kw.setdefault("members", 2)
    return union.Experiment(
        name=kw.pop("name", "serve-t"),
        scenarios=[union.Scenario(
            name="tiny",
            jobs=[union.ScenarioJob(app="pp0", source=PP, ranks=2)],
            placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=256,
        )], **kw)


def test_lifecycle_and_store_replay(client, tmp_path):
    with open(SMOKE) as f:
        spec = json.load(f)
    job_id = client.submit(SMOKE)
    assert job_id.startswith("exp-")
    st = client.wait(job_id, timeout=300)
    assert st["status"] == "done"
    assert st["cells_total"] == st["cells_completed"] > 0
    assert st["store"]["hits"] == 0
    assert st["store"]["misses"] == st["cells_total"]
    r1 = client.results(job_id)
    assert len(r1.cells) == st["cells_total"]
    assert r1.schema_version == 4

    # the JAX package's server, on the same spec, gives the same cells
    ref = serving(ref_make_server(store=str(tmp_path / "ref-store")))
    try:
        want = ServeClient(f"http://127.0.0.1:{ref.port}")
        ref_id = want.submit(SMOKE)
        assert want.wait(ref_id, timeout=300)["status"] == "done"
        assert_cells_match(r1.cells, REF.Results.from_dict(
            want._request("GET", f"/experiments/{ref_id}/results")).cells)
    finally:
        ref.close()

    # re-submit the identical spec: every cell replays from the store
    job2 = client.submit(spec)
    assert job2 != job_id
    st2 = client.wait(job2, timeout=120)
    assert st2["status"] == "done"
    assert st2["store"]["hits"] == st["cells_total"]
    assert st2["store"]["misses"] == 0
    r2 = client.results(job2)
    assert [c.to_dict() for c in r2.cells] == [c.to_dict()
                                               for c in r1.cells]
    jobs = client.jobs()["jobs"]
    assert [j["id"] for j in jobs[:2]] == [job2, job_id]


def test_concurrent_submissions_both_complete(client):
    a = client.submit(tiny_experiment(name="conc-a"))
    b = client.submit(tiny_experiment(name="conc-b", base_seed=11))
    sa, sb = client.wait(a, timeout=300), client.wait(b, timeout=300)
    assert sa["status"] == sb["status"] == "done"
    assert len(client.results(a).cells) == 2
    assert len(client.results(b).cells) == 2
    # the one worker serialized them: execution windows don't overlap
    first, second = sorted((sa, sb), key=lambda s: s["started_at"])
    assert first["finished_at"] <= second["started_at"]


def test_submit_and_wait_helper(client, server):
    res = submit_and_wait(f"http://127.0.0.1:{server.port}",
                          tiny_experiment(name="conc-a"), timeout=120)
    assert res.telemetry["store"]["misses"] == 0  # warm from previous test
    direct = union.run(tiny_experiment(name="conc-a"), device="cpu")
    assert_cells_match(res.cells, direct.cells)


def test_health_and_metrics(client):
    h = client.health()
    assert h["status"] == "ok"
    assert set(h["engine_cache"]) >= {"hits", "misses", "builds",
                                      "evictions", "size", "limit"}
    assert h["store"]["entries"] > 0
    text = client.metrics()
    assert text.endswith("# EOF\n")
    assert "# TYPE union_serve_requests counter" in text
    assert 'union_serve_requests_total{route="submit"}' in text
    assert "# TYPE union_cells_completed counter" in text
    assert "# TYPE union_serve_queue_depth gauge" in text
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert line.rsplit(" ", 1)[1].replace(".", "").replace(
                "-", "").replace("e", "").replace("+", "").isdigit()


class _Gate:
    """node_hook test seam: pause the worker at the first cancel poll
    (before any node simulates) until the test releases it."""

    def __init__(self):
        self.paused = threading.Event()
        self.release = threading.Event()

    def __call__(self, job):
        self.paused.set()
        assert self.release.wait(timeout=60), "test never released gate"


def test_cancel_running_and_queued(tmp_path):
    gate = _Gate()
    srv = serving(make_server(store=str(tmp_path / "store"), node_hook=gate,
                              device="cpu"))
    try:
        c = ServeClient(f"http://127.0.0.1:{srv.port}")
        a = c.submit(tiny_experiment(name="cancel-a"))
        assert gate.paused.wait(timeout=60)  # worker is inside job A
        assert c.status(a)["status"] == "running"
        b = c.submit(tiny_experiment(name="cancel-b"))
        assert c.status(b)["status"] == "queued"
        assert c.cancel(b)["cancel_requested"]
        assert c.status(b)["status"] == "cancelled"
        c.cancel(a)
        gate.release.set()
        st = c.wait(a, timeout=60)
        assert st["status"] == "cancelled"
        assert st["cells_completed"] == 0  # cancelled before node 0
        with pytest.raises(ServeError) as ei:
            c.results(a)
        assert ei.value.status == 409
        assert c.cancel(a)["status"] == "cancelled"
    finally:
        gate.release.set()
        srv.close()


def test_error_codes(client, server):
    for call in (lambda: client.status("exp-nope"),
                 lambda: client.results("exp-nope"),
                 lambda: client.cancel("exp-nope"),
                 lambda: client._request("GET", "/bogus")):
        with pytest.raises(ServeError) as ei:
            call()
        assert ei.value.status == 404
    with pytest.raises(ServeError) as ei:
        client._request("GET", "/experiments/exp-nope/cancel")
    assert ei.value.status == 405
    with pytest.raises(ServeError) as ei:
        client._request("POST", "/experiments", body=None)
    assert ei.value.status == 400
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/experiments",
        data=b"{not json", method="POST",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as he:
        urllib.request.urlopen(req, timeout=30)
    assert he.value.code == 400
    with pytest.raises(ServeError) as ei:
        client._request("POST", "/experiments",
                        body={"name": "bad", "scenarios": [],
                              "definitely_not_a_field": 1})
    assert ei.value.status == 400


def test_index_lists_endpoints(client):
    idx = client._request("GET", "/")
    assert idx["service"] == "repro_torch.union.serve"
    assert any("/experiments" in e for e in idx["endpoints"])
