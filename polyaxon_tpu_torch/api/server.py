"""REST API server over the embedded control plane (port of
``polyaxon_tpu/api/server.py``): the same routes and answers over the
port's ``ControlPlane``, with stdlib ``ThreadingHTTPServer``:

    POST /api/v1/{owner}/{project}/runs              submit operation
    GET  /api/v1/{owner}/{project}/runs              list (status=, pipeline=)
    GET  /api/v1/{owner}/{project}/runs/{uuid}       run detail
    POST /api/v1/{owner}/{project}/runs/{uuid}/stop|restart|resume
    GET  .../statuses | metrics | outputs | artifacts[/{path}]
    GET  /streams/v1/{owner}/{project}/runs/{uuid}/logs[?follow=true]  (SSE)
    GET  /healthz | /api/v1/version | /api/v1/projects

Authentication: ``ApiServer(auth_token=...)`` turns on
bearer-token auth — the shared secret grants admin access to every
owner; ``owner_tokens={"alice": "tk"}`` adds per-owner tokens that can
only read/mutate runs under their own ``{owner}`` path segment (and
only runs stamped with that owner at submit). Without either, the
server stays open (embedded single-user default; the ``owner`` path
segment is then accepted for upstream URL compatibility and ignored).
"""

from __future__ import annotations

import hmac
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from polyaxon_tpu_torch import __version__
from polyaxon_tpu_torch.controlplane.service import ControlPlane
from polyaxon_tpu_torch.controlplane.store import RunRecord


def _record_json(record: RunRecord) -> dict[str, Any]:
    return {
        "uuid": record.uuid,
        "name": record.name,
        "project": record.project,
        "kind": record.kind,
        "status": record.status.value,
        "created_at": record.created_at,
        "finished_at": record.finished_at,
        "params": record.params,
        "tags": record.tags,
        "meta": record.meta,
        "pipeline_uuid": record.pipeline_uuid,
        "parent_uuid": record.parent_uuid,
        "retries": record.retries,
    }


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class _Handler(BaseHTTPRequestHandler):
    plane: ControlPlane  # injected by ApiServer via class attribute
    auth_token: Optional[str] = None  # admin shared secret (None = open)
    owner_tokens: dict[str, str] = {}  # owner -> per-owner token
    protocol_version = "HTTP/1.1"

    # -- auth --------------------------------------------------------------
    @property
    def _auth_enabled(self) -> bool:
        return bool(self.auth_token or self.owner_tokens)

    # Derived stream tokens: ?token= URLs land in
    # reverse-proxy logs, browser history, and Referer headers, so the
    # header-less routes (SSE/EventSource, <img> artifact loads) should
    # never carry a long-lived primary secret. /api/v1/stream-token
    # (header-auth) mints an HMAC-derived credential with a short TTL;
    # the dashboard uses those in URLs and only ever sends the primary
    # in an Authorization header. Primary tokens are still accepted in
    # the query for curl-style use — the mint is the browser fix, not a
    # protocol break.
    STREAM_TOKEN_TTL = 300

    def _stream_key(self, caller: str) -> Optional[str]:
        return (self.auth_token if caller == "*"
                else self.owner_tokens.get(caller))

    def _mint_stream_token(self, caller: str) -> str:
        key = self._stream_key(caller)
        if not key:
            raise ApiError(400, "no primary token to derive from")
        exp = int(time.time()) + self.STREAM_TOKEN_TTL
        msg = f"st:{caller}:{exp}"
        sig = hmac.new(key.encode(), msg.encode(), "sha256").hexdigest()
        return f"{msg}:{sig}"

    def _verify_stream_token(self, raw: str) -> str:
        parts = raw.split(":")
        # st:{caller}:{exp}:{sig} — caller may itself contain ':'.
        caller, exp_s, sig = ":".join(parts[1:-2]), parts[-2], parts[-1]
        key = self._stream_key(caller)
        if not key or not exp_s.isdigit():
            raise ApiError(401, "invalid token")
        msg = f"st:{caller}:{exp_s}"
        want = hmac.new(key.encode(), msg.encode(), "sha256").hexdigest()
        if not hmac.compare_digest(sig.encode(), want.encode()):
            raise ApiError(401, "invalid token")
        if int(exp_s) < time.time():
            raise ApiError(401, "stream token expired")
        return caller

    def _caller(self, query_token: Optional[str] = None) -> Optional[str]:
        """``"*"`` for the admin secret, the owner name for a per-owner
        token, ``None`` for no credentials. Unknown tokens are 401 —
        constant-time compares so the check can't leak secret prefixes.
        ``query_token``: header-less fallback used by the SSE log route
        ONLY — the browser EventSource API cannot set headers.
        """
        if not self._auth_enabled:
            return "*"  # open server: any credentials are ignored
        header = self.headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            if not query_token:
                return None
            if query_token.startswith("st:") and query_token.count(":") >= 3:
                # A primary token may itself look like a stream token
                # ("st:"-prefixed with colons); if stream verification
                # rejects, fall through to the primary comparison below
                # instead of locking that credential out of the
                # header-less routes. Forged/expired stream
                # tokens still 401 there — they match no primary.
                try:
                    return self._verify_stream_token(query_token)
                except ApiError:
                    pass
            raw = query_token
        else:
            raw = header[len("Bearer "):]
        # Compare as bytes: compare_digest raises TypeError on
        # non-ASCII str (http.server decodes headers latin-1), which
        # would turn attacker-controlled input into a 500, not a 401.
        token = raw.strip().encode("utf-8", "replace")
        if self.auth_token and hmac.compare_digest(
                token, self.auth_token.encode("utf-8", "replace")):
            return "*"
        for owner, expected in self.owner_tokens.items():
            if hmac.compare_digest(token, expected.encode("utf-8", "replace")):
                return owner
        raise ApiError(401, "invalid token")

    def _require(self, caller: Optional[str], owner: Optional[str] = None,
                 admin: bool = False) -> None:
        """401 without credentials; 403 when the token's scope does not
        cover ``owner`` (or ``admin`` is required). No-op when auth is
        off."""
        if not self._auth_enabled:
            return
        if caller is None:
            raise ApiError(401, "missing bearer token")
        if caller == "*":
            return
        if admin:
            raise ApiError(403, "admin token required")
        if owner is not None and caller != owner:
            raise ApiError(
                403, f"token for owner `{caller}` cannot access "
                     f"owner `{owner}`")

    def _require_run(self, caller: Optional[str], record: RunRecord) -> None:
        """Record-level isolation: a scoped token only touches runs
        stamped with its owner at submit — path spoofing (A's run uuid
        under B's path) and pre-auth legacy runs both fall to admin."""
        if not self._auth_enabled or caller in (None, "*"):
            return
        if (record.meta or {}).get("owner") != caller:
            raise ApiError(
                403, f"run {record.uuid} is not owned by `{caller}`")

    # -- plumbing ----------------------------------------------------------
    def log_message(self, *args):  # quiet; the agent log is the log
        pass

    def _json(self, payload: Any, status: int = 200) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        try:
            return json.loads(self.rfile.read(length).decode())
        except json.JSONDecodeError as exc:
            raise ApiError(400, f"invalid JSON body: {exc}") from exc

    # -- routing -----------------------------------------------------------
    def do_GET(self):  # noqa: N802
        self._route("GET")

    def do_POST(self):  # noqa: N802
        self._route("POST")

    def _route(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        parts = [urllib.parse.unquote(p) for p in parsed.path.split("/") if p]
        query = urllib.parse.parse_qs(parsed.query)
        try:
            self._dispatch(method, parts, query)
        except ApiError as exc:
            self._json({"error": exc.message}, status=exc.status)
        except (ValueError, KeyError) as exc:
            self._json({"error": str(exc)}, status=400)
        except BrokenPipeError:
            pass
        except Exception as exc:  # pragma: no cover - last resort
            self._json({"error": f"{type(exc).__name__}: {exc}"}, status=500)

    def _get_run(self, uuid: str) -> RunRecord:
        try:
            return self.plane.get_run(uuid)
        except Exception as exc:
            raise ApiError(404, f"run {uuid} not found") from exc

    def _dispatch(self, method: str, parts: list[str], query: dict) -> None:
        # Open routes: liveness, scrape, the dashboard page itself, and
        # version. Everything that exposes run DATA authenticates.
        if parts == ["healthz"]:
            return self._json({"status": "ok"})
        if parts == ["metrics"]:
            return self._prometheus()
        if parts in ([], ["ui"]):
            return self._dashboard()
        caller = self._caller()  # may raise 401 on a bad token
        if parts[:2] == ["api", "v1"]:
            rest = parts[2:]
            if rest == ["version"]:
                return self._json({"version": __version__})
            if rest == ["stream-token"]:
                # Header auth ONLY (a stream token cannot mint another).
                self._require(caller)
                return self._json({
                    "token": self._mint_stream_token(caller),
                    "expiresIn": self.STREAM_TOKEN_TTL,
                })
            if rest == ["projects"]:
                self._require(caller, admin=True)
                return self._json(self.plane.store.list_projects())
            if rest == ["alerts"]:
                # Live alert-rule state (obs.rules): firing alerts,
                # per-rule values vs thresholds, fired/resolved history.
                # Any authenticated caller may read — alert state is how
                # tenants learn the cluster (not another tenant's data)
                # is degraded. Evaluated on read so a plane without a
                # reconciling agent still answers truthfully.
                self._require(caller)
                return self._json(self._alerts())
            if rest == ["metrics", "history"]:
                # Sampled metrics history (obs.history): the bounded
                # ring the alert engine and the telemetry oracle share.
                # Same read posture as /alerts — cluster telemetry, any
                # authenticated caller; ?name= picks a family, ?window=
                # scopes to a marked window or a trailing span, ?labels=
                # (k=v,...) picks one series.
                self._require(caller)
                return self._json(self._history(query))
            if rest and rest[0] == "queues":
                return self._queues(method, caller, rest[1:])
            if rest and rest[0] == "quotas":
                return self._quotas(method, caller, rest[1:])
            if rest == ["agent", "slices"]:
                # The C++ slice pool's operator view (empty when this
                # server runs without a slice-managing agent).
                self._require(caller, admin=True)
                manager = getattr(self, "slice_manager", None)
                return self._json(manager.stats() if manager is not None
                                  else {"slices": [], "gangs": []})
            # /{owner}/{project}/runs...
            if len(rest) >= 3 and rest[2] == "runs":
                if (caller is None and "token" in query and method == "GET"
                        and len(rest) >= 6 and rest[4] == "artifacts"):
                    # <img src>/<a href> loads cannot set headers (same
                    # constraint as EventSource): artifact-FILE reads
                    # (only) accept ?token= as the credential.
                    caller = self._caller(query_token=query["token"][0])
                self._require(caller, owner=rest[0])
                return self._runs(method, caller, rest[0], rest[1],
                                  rest[3:], query)
        if parts[:2] == ["streams", "v1"]:
            rest = parts[2:]
            # /{owner}/{project}/runs/{uuid}/logs
            if len(rest) >= 5 and rest[2] == "runs" and rest[4] == "logs":
                if caller is None and "token" in query:
                    # EventSource cannot set headers: the SSE route
                    # (only) accepts ?token= as the credential.
                    caller = self._caller(query_token=query["token"][0])
                self._require(caller, owner=rest[0])
                return self._logs(caller, rest[3], query)
        raise ApiError(404, f"no route for {method} {'/'.join(parts)}")

    # -- scheduling catalog ------------------------------------------------
    def _queues(self, method: str, caller: Optional[str],
                rest: list[str]) -> None:
        """GET /api/v1/queues            — queues + live depth/usage
           GET /api/v1/queues/{name}     — one queue + its queued runs
           POST /api/v1/queues           — create/update (admin)
           POST /api/v1/queues/{name}/delete (admin)
        Reads are open to any authenticated caller (queue depth is how
        tenants see where their run sits); writes are operator-only."""
        stats = None
        if method == "GET":
            self._require(caller)
            stats = self.plane.scheduling_stats()
            if not rest:
                return self._json(stats["queues"])
            name = rest[0]
            for queue in stats["queues"]:
                if queue["name"] == name:
                    return self._json(queue)
            raise ApiError(404, f"queue {name} not found")
        self._require(caller, admin=True)
        if not rest:
            body = self._read_body()
            name = body.get("name")
            if not name:
                raise ApiError(400, "queue body requires `name`")
            queue = self.plane.upsert_queue(
                name,
                priority=int(body.get("priority") or 0),
                concurrency=body.get("concurrency"),
                preemptible=bool(body.get("preemptible")),
                description=body.get("description") or "",
            )
            return self._json(queue, status=201)
        if len(rest) == 2 and rest[1] == "delete":
            try:
                removed = self.plane.delete_queue(rest[0])
            except ValueError as exc:
                raise ApiError(400, str(exc)) from exc
            if not removed:
                raise ApiError(404, f"queue {rest[0]} not found")
            return self._json({"deleted": rest[0]})
        raise ApiError(404, f"no queue route for {'/'.join(rest)}")

    def _quotas(self, method: str, caller: Optional[str],
                rest: list[str]) -> None:
        """GET /api/v1/quotas — per-project quota rows + usage;
           POST /api/v1/quotas — set a project quota (admin)."""
        if method == "GET":
            self._require(caller)
            stats = self.plane.scheduling_stats()
            return self._json({"quotas": stats["quotas"],
                               "projects": stats["projects"]})
        self._require(caller, admin=True)
        if not rest:
            body = self._read_body()
            project = body.get("project")
            if not project:
                raise ApiError(400, "quota body requires `project`")
            quota = self.plane.set_quota(
                project,
                max_runs=body.get("maxRuns", body.get("max_runs")),
                max_chips=body.get("maxChips", body.get("max_chips")),
                weight=float(body.get("weight") or 1.0),
            )
            return self._json(quota, status=201)
        if len(rest) == 2 and rest[1] == "delete":
            if not self.plane.delete_quota(rest[0]):
                raise ApiError(404, f"quota for {rest[0]} not found")
            return self._json({"deleted": rest[0]})
        raise ApiError(404, f"no quota route for {'/'.join(rest)}")

    def _alerts(self) -> dict:
        from polyaxon_tpu_torch.obs import rules as obs_rules

        engine = obs_rules.default_engine()
        engine.evaluate(plane=self.plane)
        return engine.to_json()

    def _history(self, query: dict) -> dict:
        from polyaxon_tpu_torch.obs import history as obs_history

        ring = obs_history.default_history()
        ring.sample()  # cadence-gated freshness on read
        name = (query.get("name") or [None])[0]
        window = (query.get("window") or [None])[0]
        raw = (query.get("labels") or [None])[0]
        labels = None
        if raw:
            labels = {}
            for part in raw.split(","):
                key, sep, value = part.partition("=")
                if not sep or not key.strip():
                    raise ApiError(400, f"bad labels selector {raw!r} "
                                        "(want k=v[,k2=v2])")
                labels[key.strip()] = value.strip()
        try:
            return obs_history.query_history(
                ring.to_json(), name=name, window=window, labels=labels)
        except ValueError as exc:
            raise ApiError(400, str(exc))

    def _dashboard(self) -> None:
        """Polyboard-lite (api.ui): the static runs dashboard."""
        from polyaxon_tpu_torch.api.ui import DASHBOARD_HTML

        body = DASHBOARD_HTML.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _prometheus(self) -> None:
        """Prometheus text exposition backed by the unified registry
        (obs.metrics).

        Scrape-time gauges rebuilt from store state here: per-lifecycle-
        phase run counts (every V1Statuses phase, zeros included) and
        queue depth/occupancy. Everything else — scheduler tick
        histograms, admission outcomes, retry/requeue counters, store
        op latency, training step time — accumulates in the registry as
        the co-located agent/runtime records it, and renders with the
        same scrape."""
        import time

        from polyaxon_tpu_torch.lifecycle import V1Statuses
        from polyaxon_tpu_torch.obs import metrics as obs_metrics

        registry = obs_metrics.REGISTRY
        registry.gauge("polyaxon_tpu_info", "Build info",
                       ("version",)).set(1, version=__version__)
        runs = registry.gauge(
            "polyaxon_runs", "Runs per lifecycle phase", ("status",))
        counts: dict[str, int] = {s.value: 0 for s in V1Statuses}
        for record in self.plane.list_runs():
            counts[record.status.value] = counts.get(record.status.value, 0) + 1
        for status, n in counts.items():
            runs.set(n, status=status)
        depth = registry.gauge(
            "polyaxon_queue_depth", "Queued runs per queue", ("queue",))
        running = registry.gauge(
            "polyaxon_queue_running", "Live runs per queue", ("queue",))
        depth.clear()
        running.clear()
        for q in self.plane.scheduling_stats()["queues"]:
            depth.set(q["depth"], queue=q["name"])
            running.set(q["running"], queue=q["name"])
        started = getattr(self.server, "started_at", None)
        if started is not None:
            registry.gauge("polyaxon_uptime_seconds",
                           "API server uptime").set(time.time() - started)
        # Stable scrape schema: the documented families (incl. the
        # histograms) exist even before their first sample.
        obs_metrics.ensure_core_metrics(registry)
        body = registry.render().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- runs --------------------------------------------------------------
    def _runs(self, method: str, caller: Optional[str], owner: str,
              project: str, rest: list[str], query: dict) -> None:
        plane = self.plane
        if not rest:
            if method == "POST":
                body = self._read_body()
                try:
                    record = plane.submit(
                        body.get("content"),
                        project=project,
                        params=body.get("params"),
                        presets=body.get("presets"),
                        name=body.get("name"),
                        tags=body.get("tags"),
                        # Stamped from the authenticated PATH (not the
                        # body): record-level isolation keys off it.
                        meta={"owner": owner},
                    )
                except ApiError:
                    raise
                except Exception as exc:
                    raise ApiError(400, f"submit failed: {exc}") from exc
                return self._json(_record_json(record), status=201)
            from polyaxon_tpu_torch.lifecycle import V1Statuses

            kwargs: dict[str, Any] = {"project": project}
            if "status" in query:
                try:
                    kwargs["statuses"] = [V1Statuses(s) for s in query["status"]]
                except ValueError as exc:
                    raise ApiError(400, str(exc)) from exc
            if "pipeline" in query:
                kwargs["pipeline_uuid"] = query["pipeline"][0]
            records = plane.list_runs(**kwargs)
            if self._auth_enabled and caller != "*":
                # Per-owner isolation on list: scoped tokens only see
                # runs stamped with their owner.
                records = [r for r in records
                           if (r.meta or {}).get("owner") == caller]
            return self._json({"count": len(records),
                               "results": [_record_json(r) for r in records]})

        uuid = rest[0]
        record = self._get_run(uuid)
        self._require_run(caller, record)
        action = rest[1] if len(rest) > 1 else None
        if action is None:
            if method == "POST":
                raise ApiError(405, "POST not allowed on run detail")
            payload = _record_json(record)
            # Detail view only: the spec carries matrix config (metric
            # name, bracket budgets) the dashboard's sweep view needs.
            payload["spec"] = record.spec
            return self._json(payload)
        if method == "POST":
            if action == "stop":
                plane.stop(uuid, message=(self._read_body().get("message") or ""))
                return self._json({"status": "stopping"})
            if action == "restart":
                body = self._read_body()
                new = plane.restart(uuid, copy=bool(body.get("copy")))
                return self._json(_record_json(new), status=201)
            if action == "resume":
                return self._json(_record_json(plane.resume(uuid)), status=201)
            raise ApiError(404, f"unknown action {action}")
        if action == "statuses":
            return self._json(plane.get_statuses(uuid))
        if action == "timeline":
            # Ordered lifecycle span tree (obs.trace): compile →
            # admission → placement → execute → runtime → sync, with
            # chaos/retry annotations. Backs the dashboard waterfall
            # and `plx ops timeline`.
            return self._json(plane.timeline(uuid))
        if action == "report":
            # Performance attribution (obs.analyze): wall clock by
            # phase, step-time trend + anomaly flags, fault annotations
            # per phase. Backs `plx ops report`.
            return self._json(plane.report(uuid))
        if action == "verify":
            # Telemetry-oracle verdicts (obs.oracle) scoped to this
            # run: committed invariants judged against its timeline,
            # report, the registry, and alert state. Backs
            # `plx ops verify`.
            return self._json(plane.verify(uuid))
        if action == "metrics":
            names = query.get("names")
            return self._json(plane.streams.get_metrics(uuid, names))
        if action == "events":
            kind = (query.get("kind") or ["metric"])[0]
            names = query.get("names")
            return self._json(plane.streams.get_events(uuid, kind, names))
        if action == "lineage":
            if rest[2:] == ["graph"]:
                # Cross-run inputs → run → outputs graph. Scoped tokens:
                # the node set is filtered to the caller's own runs so a
                # graph cannot leak another owner's run names.
                graph = plane.lineage_graph(uuid)
                if caller not in (None, "*"):
                    # Nodes carry their owner stamp — no per-node
                    # store fetch needed to filter foreign runs out.
                    visible = {n["uuid"] for n in graph["nodes"]
                               if n.get("owner") == caller}
                    graph["nodes"] = [n for n in graph["nodes"]
                                      if n["uuid"] in visible]
                    graph["edges"] = [e for e in graph["edges"]
                                      if e["from"] in visible
                                      and e["to"] in visible]
                return self._json(graph)
            return self._json(plane.streams.get_lineage(uuid))
        if action == "outputs":
            return self._json(plane.streams.get_outputs(uuid))
        if action == "artifacts":
            if len(rest) > 2:
                return self._artifact(uuid, "/".join(rest[2:]))
            if (query.get("detail") or ["0"])[0] in ("1", "true"):
                return self._json(plane.streams.list_artifacts_detail(uuid))
            return self._json(plane.streams.list_artifacts(uuid))
        raise ApiError(404, f"unknown sub-resource {action}")

    def _artifact(self, uuid: str, rel: str) -> None:
        import mimetypes
        import os

        path = self.plane.streams.artifact_path(uuid, rel)
        if not os.path.isfile(path):
            raise ApiError(404, f"artifact {rel} not found")
        size = os.path.getsize(path)
        # Real content types so the dashboard renders logged images/
        # html inline (a jsonl/log/unknown file stays a download).
        # CSP sandbox: artifacts are run-produced content served from
        # the API origin — an html/svg artifact must render without
        # script execution or API credentials (stored-XSS guard).
        ctype = (mimetypes.guess_type(path)[0]
                 or "application/octet-stream")
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("X-Content-Type-Options", "nosniff")
        self.send_header("Content-Security-Policy", "sandbox")
        self.send_header("Content-Length", str(size))
        self.end_headers()
        # Stream exactly `size` bytes: a live run may append between the
        # stat and the read, and extra bytes would corrupt keep-alive
        # framing (the client parses them as the next response).
        remaining = size
        with open(path, "rb") as fh:
            while remaining > 0:
                chunk = fh.read(min(1 << 16, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
                self.wfile.write(chunk)

    # -- streams -----------------------------------------------------------
    def _logs(self, caller: Optional[str], uuid: str, query: dict) -> None:
        import time

        record = self._get_run(uuid)
        self._require_run(caller, record)
        follow = query.get("follow", ["false"])[0].lower() == "true"
        streams = self.plane.streams
        if not follow:
            text = ""
            for name in streams.log_files(uuid):
                chunk, _ = streams.read_logs(uuid, name)
                text += chunk
            return self._json({"logs": text})

        # SSE, ALWAYS (even when the run already finished — the client
        # contract is `data:` events then `event: done`): tail every log
        # file of the gang, interleaved as content appears.
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        offsets: dict[str, int] = {}

        def emit_available() -> bool:
            wrote = False
            for name in streams.log_files(uuid):
                chunk, offsets[name] = streams.read_logs(
                    uuid, name, offsets.get(name, 0))
                if chunk:
                    payload = "".join(
                        f"data: {line}\n" for line in chunk.splitlines())
                    self.wfile.write((payload + "\n").encode())
                    wrote = True
            if wrote:
                self.wfile.flush()
            return wrote

        try:
            while True:
                wrote = emit_available()
                if self.plane.get_run(uuid).is_done:
                    emit_available()  # final drain after terminal status
                    break
                if not wrote:
                    time.sleep(0.2)
            self.wfile.write(b"event: done\ndata: \n\n")
        except BrokenPipeError:
            pass


class ApiServer:
    """Owns the HTTP server thread; ``with ApiServer(plane) as s: s.port``."""

    def __init__(self, plane: ControlPlane, host: str = "127.0.0.1",
                 port: int = 0, slice_manager=None,
                 auth_token: Optional[str] = None,
                 owner_tokens: Optional[dict[str, str]] = None):
        import time

        handler = type("BoundHandler", (_Handler,),
                       {"plane": plane, "slice_manager": slice_manager,
                        "auth_token": auth_token,
                        "owner_tokens": owner_tokens or {}})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.started_at = time.time()
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            # Drain the serve loop so in-flight handlers finish before
            # teardown (a daemon thread dies mid-response at exit).
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


