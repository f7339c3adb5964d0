"""The port's REST API, dashboard and client (``polyaxon_tpu_torch/api``,
``client``) against the JAX package's, on the CPU.

Two stacks, one per package, each a plane with its agent reconciling in
a thread and two ``ApiServer``s on ephemeral ports over it (one open, one
with an admin token and a per-owner token), are fed the same
submissions through each package's ``RunClient``: a trial that prints,
writes a metric, its outputs and a file; a slow run that is stopped,
then restarted and resumed; a run of another owner; queues and a quota
set over the admin routes. Then every route family is read from both
and the answers are held equal: runs list/get/statuses/logs/metrics/
events/artifacts (listing and one file)/lineage and its graph, projects,
queues, quotas, the slice pool's view, alerts, the metrics history, the
dashboard's bytes, 401 and 403 under tokens, stream tokens, and
stop/restart/resume. ``PolyaxonClient`` and ``RunClient`` of each
package against its server return equal results.

Normalisation: run uuids are replaced by ``<run-N>`` in the order they
first appear in each stack, ISO and float times by ``<time>``, the sizes
of ``*.jsonl`` files (which hold times) by ``<size>``, ports by
``<port>``, homes by ``<home>``; the alerts and history answers are
compared by their rule and family names, thresholds, severities and
states, not the sampled values and times (the two planes' registries
sample their own clocks).
"""

import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.torch_deadline import deadline

TRIAL = {
    "kind": "component",
    "name": "trial",
    "inputs": [{"name": "lr", "type": "float", "toEnv": "LR"}],
    "run": {"kind": "job", "container": {"command": [
        sys.executable, "-c",
        "import json, os\n"
        "d = os.environ['POLYAXON_RUN_ARTIFACTS_PATH']\n"
        "os.makedirs(d + '/events/metric', exist_ok=True)\n"
        "print('training with lr', os.environ['LR'], flush=True)\n"
        "score = (float(os.environ['LR']) - 0.3) ** 2\n"
        "with open(d + '/events/metric/score.jsonl', 'a') as fh:\n"
        "    fh.write(json.dumps({'step': 1, 'value': score}) + '\\n')\n"
        "json.dump({'score': score}, open(d + '/outputs.json', 'w'))\n"
        "open(d + '/report.html', 'w').write('<h1>eval</h1>')\n"]}},
}
SLOW = {"kind": "component", "name": "slow", "run": {
    "kind": "job", "container": {"command": [
        sys.executable, "-c", "import time; time.sleep(30)"]}}}
ADMIN, ALICE = "admin-secret", "tk-alice"


def _ns(pkg):
    if pkg == "jax":
        from polyaxon_tpu.agent import Agent
        from polyaxon_tpu.api import ApiServer
        from polyaxon_tpu.client import client as client_mod
        from polyaxon_tpu.controlplane import ControlPlane
        from polyaxon_tpu.tracking import Run
    else:
        from polyaxon_tpu_torch.agent import Agent
        from polyaxon_tpu_torch.api import ApiServer
        from polyaxon_tpu_torch.client import client as client_mod
        from polyaxon_tpu_torch.controlplane import ControlPlane
        from polyaxon_tpu_torch.tracking import Run
    return Agent, ApiServer, client_mod, ControlPlane, Run


class Stack:
    def __init__(self, pkg, home):
        Agent, ApiServer, client_mod, ControlPlane, Run = _ns(pkg)
        self.pkg, self.home, self.client_mod = pkg, home, client_mod
        self.plane = ControlPlane(home)
        agent = Agent(self.plane, max_concurrent=4)
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                agent.reconcile_once()
                time.sleep(0.05)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        self.open = ApiServer(self.plane).start()
        self.auth = ApiServer(self.plane, auth_token=ADMIN,
                              owner_tokens={"alice": ALICE}).start()
        self.Run = Run
        self.ids: dict[str, str] = {}

    def client(self, server=None, **kw):
        return self.client_mod.PolyaxonClient((server or self.open).url,
                                              **kw)

    def run_client(self, uuid=None, project="default", client=None):
        return self.client_mod.RunClient(project, uuid,
                                         client=client or self.client())

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)
        for server in (self.open, self.auth):
            server.stop()

    def norm(self, value):
        """The normalised JSON text of ``value``."""
        text = json.dumps(_scrub(value), sort_keys=True, default=str)
        for uuid in re.findall(r"(?<![\d.])\b[0-9a-f]{12}\b(?![\d.])", text):
            self.ids.setdefault(uuid, f"<run-{len(self.ids)}>")
        for uuid, label in self.ids.items():
            text = text.replace(uuid, label)
        text = re.sub(r"\d{4}-\d\d-\d\dT[\d:.]+(\+00:00)?", "<time>", text)
        text = text.replace(self.home, "<home>")
        for server in (self.open, self.auth):
            text = text.replace(str(server.port), "<port>")
        return text


def _scrub(value):
    """The sizes of files that hold times (``*.jsonl``) and float
    timestamps replaced by placeholders."""
    if isinstance(value, (list, tuple)):
        return [_scrub(v) for v in value]
    if not isinstance(value, dict):
        return value
    out = {k: _scrub(v) for k, v in value.items()}
    if str(out.get("path", "")).endswith(".jsonl") and "size_bytes" in out:
        out["size_bytes"] = "<size>"
    for key in TIME_KEYS & set(out):
        if isinstance(out[key], float):
            out[key] = "<time>"
    return out


TIME_KEYS = {"time", "at", "created_at", "timestamp", "start", "end",
             "mtime", "updated_at", "finished_at"}


def _feed(stack) -> dict:
    """The same submissions through this stack's client; returns the
    uuids by role."""
    admin = stack.client(stack.auth, token=ADMIN)
    alice = stack.client(stack.auth, owner="alice", token=ALICE)
    admin.post("/api/v1/queues", body={"name": "batch", "priority": 3,
                                       "concurrency": 2})
    admin.post("/api/v1/queues", body={"name": "gone"})
    admin.post("/api/v1/queues/gone/delete")
    admin.post("/api/v1/quotas", body={"project": "default", "maxRuns": 8,
                                       "weight": 2.0})
    trial = stack.run_client()
    trial.create(TRIAL, params={"lr": 0.5}, name="trial", tags=["t1"])
    assert trial.wait(timeout=60).value == "succeeded"
    mine = alice.post("/api/v1/alice/default/runs",
                      body={"content": TRIAL, "params": {"lr": 0.1},
                            "name": "alices"})
    slow = stack.run_client()
    slow.create(SLOW)
    end = time.monotonic() + 30
    while slow.status.value != "running":
        assert time.monotonic() < end
        time.sleep(0.05)
    slow.stop(message="enough")
    assert slow.wait(timeout=30).value == "stopped"
    # The lineage records of a model the trial logged, written alike.
    art = stack.plane.run_artifacts_dir(trial.run_uuid)
    with open(os.path.join(art, "model.bin"), "w") as fh:
        fh.write("weights")
    with stack.Run(trial.run_uuid, art) as run:
        run.log_model(os.path.join(art, "model.bin"), name="model.bin")
    return {"trial": trial.run_uuid, "alice": mine["uuid"],
            "slow": slow.run_uuid}


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """Both stacks, fed alike (the JAX one first, so uuids number in
    the same order)."""
    import polyaxon_tpu.client.client as jclient
    import polyaxon_tpu_torch.client.client as tclient

    cfg = str(tmp_path_factory.mktemp("cfg") / "no-such-config.json")
    saved = {m: m.CONFIG_FILE for m in (jclient, tclient)}
    env = {k: os.environ.pop(k, None)
           for k in ("POLYAXON_TPU_TOKEN", "POLYAXON_TPU_HOST")}
    for m in saved:
        m.CONFIG_FILE = cfg
    from polyaxon_tpu.obs import metrics as jmetrics
    from polyaxon_tpu.obs import rules as jrules
    from polyaxon_tpu_torch.obs import metrics as tmetrics
    from polyaxon_tpu_torch.obs import rules as trules

    # Both registries, rings and alert engines start empty: what the
    # alerts answer judges this module's traffic alone.
    for metrics_mod, rules_mod in ((jmetrics, jrules), (tmetrics, trules)):
        metrics_mod.REGISTRY.reset()
        rules_mod.set_default_engine(None)
    out = {}
    try:
        for pkg in ("jax", "torch"):
            stack = Stack(pkg, str(tmp_path_factory.mktemp(pkg)))
            out[pkg] = (stack, _feed(stack))
        yield out
    finally:
        for stack, _ in out.values():
            stack.close()
        for m, path in saved.items():
            m.CONFIG_FILE = path
        os.environ.update({k: v for k, v in env.items() if v is not None})


def _http(url, token=None, method="GET", body=None):
    """(status, content type, body bytes) of one request."""
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    data = json.dumps(body).encode() if body is not None else None
    if data:
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers["Content-Type"], exc.read()


def _both(stacks, fn):
    """``fn(stack, ids)`` normalised, for each package."""
    return {pkg: stack.norm(fn(stack, ids))
            for pkg, (stack, ids) in stacks.items()}


def _run_path(stack, ids, role, sub=""):
    return (f"{stack.open.url}/api/v1/default/default/runs/{ids[role]}"
            f"{sub}")


ROUTES = {
    "runs_list": lambda s, i: f"{s.open.url}/api/v1/default/default/runs",
    "runs_list_status": lambda s, i: (
        f"{s.open.url}/api/v1/default/default/runs?status=succeeded"),
    "run_get": lambda s, i: _run_path(s, i, "trial"),
    "run_statuses": lambda s, i: _run_path(s, i, "trial", "/statuses"),
    "run_metrics": lambda s, i: _run_path(s, i, "trial", "/metrics"),
    "run_events": lambda s, i: _run_path(s, i, "trial",
                                         "/events?kind=metric"),
    "run_events_bad_kind": lambda s, i: _run_path(s, i, "trial",
                                                  "/events?kind=histgram"),
    "run_outputs": lambda s, i: _run_path(s, i, "trial", "/outputs"),
    "run_artifacts": lambda s, i: _run_path(s, i, "trial", "/artifacts"),
    "run_artifacts_detail": lambda s, i: _run_path(
        s, i, "trial", "/artifacts?detail=1"),
    "run_artifact_file": lambda s, i: _run_path(
        s, i, "trial", "/artifacts/report.html"),
    "run_artifact_missing": lambda s, i: _run_path(
        s, i, "trial", "/artifacts/nope.txt"),
    "run_lineage": lambda s, i: _run_path(s, i, "trial", "/lineage"),
    "run_lineage_graph": lambda s, i: _run_path(s, i, "trial",
                                                "/lineage/graph"),
    "run_slow_statuses": lambda s, i: _run_path(s, i, "slow", "/statuses"),
    "run_unknown": lambda s, i: (
        f"{s.open.url}/api/v1/default/default/runs/nope-nope"),
    "logs": lambda s, i: (f"{s.open.url}/streams/v1/default/default/runs/"
                          f"{i['trial']}/logs"),
    "logs_sse": lambda s, i: (f"{s.open.url}/streams/v1/default/default/"
                              f"runs/{i['trial']}/logs?follow=true"),
    "projects": lambda s, i: f"{s.open.url}/api/v1/projects",
    "queues": lambda s, i: f"{s.open.url}/api/v1/queues",
    "queue_one": lambda s, i: f"{s.open.url}/api/v1/queues/batch",
    "queue_missing": lambda s, i: f"{s.open.url}/api/v1/queues/gone",
    "quotas": lambda s, i: f"{s.open.url}/api/v1/quotas",
    "slices": lambda s, i: f"{s.open.url}/api/v1/agent/slices",
    "version": lambda s, i: f"{s.open.url}/api/v1/version",
    "healthz": lambda s, i: f"{s.open.url}/healthz",
    "dashboard": lambda s, i: f"{s.open.url}/",
    "dashboard_ui": lambda s, i: f"{s.open.url}/ui",
    "no_route": lambda s, i: f"{s.open.url}/api/v2/nothing",
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_answers_equal(route, stacks):
    seen = _both(stacks, lambda s, i: _decode(_http(ROUTES[route](s, i))))
    assert seen["torch"] == seen["jax"]


def _decode(answer):
    status, ctype, body = answer
    if ctype == "application/json":
        return status, ctype, json.loads(body)
    return status, ctype, body.decode()


def test_dashboard_bytes_equal(stacks):
    bodies = {pkg: _http(f"{s.open.url}/ui")[2]
              for pkg, (s, _) in stacks.items()}
    assert bodies["torch"] == bodies["jax"] and b"<html" in bodies["torch"]


# (route, token): anonymous and mis-scoped requests on the auth server.
AUTH_CASES = {
    "anon_runs": ("/api/v1/alice/default/runs", None),
    "anon_projects": ("/api/v1/projects", None),
    "bad_token": ("/api/v1/alice/default/runs", "wrong"),
    "alice_own_runs": ("/api/v1/alice/default/runs", ALICE),
    "alice_other_owner": ("/api/v1/default/default/runs", ALICE),
    "alice_projects": ("/api/v1/projects", ALICE),
    "alice_slices": ("/api/v1/agent/slices", ALICE),
    "alice_queues": ("/api/v1/queues", ALICE),
    "alice_version": ("/api/v1/version", ALICE),
    "admin_runs": ("/api/v1/default/default/runs", ADMIN),
    "anon_healthz": ("/healthz", None),
    "anon_logs": ("/streams/v1/alice/default/runs/{alice}/logs", None),
    "alice_logs": ("/streams/v1/alice/default/runs/{alice}/logs", ALICE),
    "alice_foreign_run": ("/api/v1/alice/default/runs/{trial}", ALICE),
}


@pytest.mark.parametrize("case", sorted(AUTH_CASES))
def test_auth_answers_equal(case, stacks):
    path, token = AUTH_CASES[case]
    seen = _both(stacks, lambda s, i: _decode(_http(
        s.auth.url + path.format(**i), token=token)))
    assert seen["torch"] == seen["jax"]


def test_auth_mutations_equal(stacks):
    """401/403 on the write routes, and a stream token minted by each
    server that the same server accepts on the SSE route."""
    def probe(stack, ids):
        url = stack.auth.url
        out = [
            _decode(_http(f"{url}/api/v1/alice/default/runs", method="POST",
                          body={"content": TRIAL})),
            _decode(_http(f"{url}/api/v1/queues", ALICE, "POST",
                          {"name": "x"})),
            _decode(_http(f"{url}/api/v1/quotas", ALICE, "POST",
                          {"project": "p"})),
            _decode(_http(f"{url}/api/v1/alice/default/runs/{ids['trial']}"
                          "/stop", ALICE, "POST", {})),
        ]
        status, _, body = _http(f"{url}/api/v1/stream-token", ALICE)
        token = json.loads(body)["token"]
        out.append((status, sorted(json.loads(body))))
        status, ctype, body = _http(
            f"{url}/streams/v1/alice/default/runs/{ids['alice']}/logs"
            f"?token={urllib.request.quote(token, safe='')}")
        out.append((status, ctype, json.loads(body)))
        return out

    seen = _both(stacks, probe)
    assert seen["torch"] == seen["jax"]


def _names(payload: dict) -> dict:
    """Alert answers without sampled values and times."""
    return {
        "alerts": sorted(a["rule"] for a in payload["alerts"]),
        "rules": sorted((r["rule"], r["metric"], r["threshold"],
                         r.get("severity")) for r in payload["rules"]),
    }


def test_alerts_and_history_equal(stacks):
    def probe(stack, ids):
        _, _, alerts = _http(f"{stack.open.url}/api/v1/alerts")
        status, _, bad = _http(
            f"{stack.open.url}/api/v1/metrics/history?labels=nope")
        _, _, hist = _http(f"{stack.open.url}/api/v1/metrics/history")
        return (_names(json.loads(alerts)), status, json.loads(bad),
                sorted(json.loads(hist)))

    seen = _both(stacks, probe)
    assert seen["torch"] == seen["jax"]


@deadline(120)
def test_clients_equal(stacks, tmp_path):
    """Each package's client against its own server: equal results,
    including stop, restart and resume."""
    def probe(stack, ids):
        client = stack.client()
        run = stack.run_client(ids["trial"], client=client)
        dest = run.download_artifact("report.html",
                                     str(tmp_path / stack.pkg / "r.html"))
        with open(dest) as fh:
            downloaded = fh.read()
        out = {
            "version": client.version(),
            "healthy": client.healthy(),
            "projects": client.list_projects(),
            "runs": client.list_runs(),
            "succeeded": client.list_runs(status="succeeded"),
            "status": run.status.value,
            "statuses": run.get_statuses(),
            "metrics": run.get_metrics(["score"]),
            "events": run.get_events("metric", ["score"]),
            "lineage": run.get_lineage(),
            "outputs": run.get_outputs(),
            "logs": run.get_logs(),
            "watched": list(run.watch_logs()),
            "artifacts": run.list_artifacts(),
            "downloaded": downloaded,
        }
        slow = stack.run_client(ids["slow"], client=client)
        resumed = slow.resume()
        resumed.stop()
        out["resumed"] = resumed.wait(timeout=30).value
        restarted = slow.restart(copy=True)
        restarted.stop()
        out["restarted"] = restarted.wait(timeout=30).value
        try:
            client.get("/api/v1/default/default/runs/nope-nope")
        except stack.client_mod.ApiClientError as exc:
            out["error"] = (exc.status, exc.message)
        out["unreachable"] = stack.client_mod.PolyaxonClient(
            "http://127.0.0.1:1").healthy()
        return out

    seen = _both(stacks, probe)
    assert seen["torch"] == seen["jax"]
