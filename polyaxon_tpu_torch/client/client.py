"""Client SDK (port of ``polyaxon_tpu/client/client.py``):
``PolyaxonClient`` (transport) + ``RunClient`` (high-level run
operations) over the REST API.

Transport is stdlib urllib against the REST server (api/server.py); no
generated swagger layer is needed because the surface is small and
typed here directly. The host resolves from (explicit arg) →
``POLYAXON_TPU_HOST`` → the client config file
(``~/.polyaxon_tpu/config.json``, written by ``plx config set`` or
``plx-torch config set``: the two CLIs share it, as they share
``POLYAXON_TPU_HOME``).
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Iterator, Optional

from polyaxon_tpu_torch.lifecycle import V1Statuses

DEFAULT_HOST = "http://127.0.0.1:8000"
CONFIG_DIR = os.path.expanduser("~/.polyaxon_tpu")
CONFIG_FILE = os.path.join(CONFIG_DIR, "config.json")


class ApiClientError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"[{status}] {message}")
        self.status = status
        self.message = message


def resolve_host(host: Optional[str] = None) -> str:
    if host:
        return host.rstrip("/")
    env = os.environ.get("POLYAXON_TPU_HOST")
    if env:
        return env.rstrip("/")
    if os.path.exists(CONFIG_FILE):
        try:
            with open(CONFIG_FILE) as fh:
                configured = json.load(fh).get("host")
            if configured:
                return str(configured).rstrip("/")
        except (OSError, json.JSONDecodeError):
            pass
    return DEFAULT_HOST


def resolve_token(token: Optional[str] = None,
                  host: Optional[str] = None) -> Optional[str]:
    """(explicit arg) → ``POLYAXON_TPU_TOKEN`` → config-file ``token``
    (``plx-torch config set --token``) → None (open server).

    The config-file credential is PAIRED with the config-file host: it
    is only attached when ``host`` is the host that config names (or
    the default, when config names none) — pointing the client at some
    other server must not disclose the saved secret to it. Explicit and
    env tokens are deliberate per-call/per-session choices and attach
    unconditionally."""
    if token:
        return token
    env = os.environ.get("POLYAXON_TPU_TOKEN")
    if env:
        return env
    if os.path.exists(CONFIG_FILE):
        try:
            with open(CONFIG_FILE) as fh:
                data = json.load(fh)
            configured = data.get("token")
            cfg_host = str(data.get("host") or DEFAULT_HOST).rstrip("/")
            if configured and (host is None or host == cfg_host):
                return str(configured)
        except (OSError, json.JSONDecodeError):
            pass
    return None


class PolyaxonClient:
    """Thin JSON-over-HTTP transport with typed errors."""

    def __init__(self, host: Optional[str] = None, *, owner: str = "default",
                 timeout: float = 30.0, token: Optional[str] = None):
        self.host = resolve_host(host)
        self.owner = owner
        self.timeout = timeout
        self.token = resolve_token(token, host=self.host)

    # ------------------------------------------------------------ transport
    def request(self, method: str, path: str, *,
                body: Optional[dict] = None, raw: bool = False) -> Any:
        url = f"{self.host}{path}"
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as exc:
            try:
                message = json.loads(exc.read().decode()).get("error", str(exc))
            except Exception:
                message = str(exc)
            raise ApiClientError(exc.code, message) from exc
        except urllib.error.URLError as exc:
            raise ApiClientError(0, f"cannot reach {self.host}: {exc.reason}") from exc
        if raw:
            return payload
        return json.loads(payload.decode()) if payload else None

    def get(self, path: str, **kw) -> Any:
        return self.request("GET", path, **kw)

    def post(self, path: str, body: Optional[dict] = None) -> Any:
        return self.request("POST", path, body=body)

    # ----------------------------------------------------------- api sugar
    def version(self) -> str:
        return self.get("/api/v1/version")["version"]

    def healthy(self) -> bool:
        try:
            return self.get("/healthz").get("status") == "ok"
        except ApiClientError:
            return False

    def list_projects(self) -> list[dict]:
        return self.get("/api/v1/projects")

    def list_runs(self, project: str = "default", *,
                  status: Optional[str] = None,
                  pipeline: Optional[str] = None) -> list[dict]:
        query = []
        if status:
            query.append(f"status={status}")
        if pipeline:
            query.append(f"pipeline={pipeline}")
        suffix = "?" + "&".join(query) if query else ""
        return self.get(
            f"/api/v1/{self.owner}/{project}/runs{suffix}")["results"]


class RunClient:
    """High-level operations on one run (create → watch → read results)."""

    def __init__(self, project: str = "default", run_uuid: Optional[str] = None,
                 *, client: Optional[PolyaxonClient] = None,
                 host: Optional[str] = None):
        self.client = client or PolyaxonClient(host)
        self.project = project
        self.run_uuid = run_uuid
        self._data: dict[str, Any] = {}

    # ---------------------------------------------------------------- paths
    def _base(self) -> str:
        return f"/api/v1/{self.client.owner}/{self.project}/runs"

    def _run_path(self, suffix: str = "") -> str:
        if not self.run_uuid:
            raise ApiClientError(400, "RunClient has no run_uuid (create first)")
        return f"{self._base()}/{self.run_uuid}{suffix}"

    # -------------------------------------------------------------- create
    def create(self, content: Any = None, *, params: Optional[dict] = None,
               presets: Optional[list] = None, name: Optional[str] = None,
               tags: Optional[list[str]] = None) -> dict:
        data = self.client.post(self._base(), body={
            "content": content, "params": params, "presets": presets,
            "name": name, "tags": tags,
        })
        self.run_uuid = data["uuid"]
        self._data = data
        return data

    # ---------------------------------------------------------------- read
    def refresh(self) -> dict:
        self._data = self.client.get(self._run_path())
        return self._data

    @property
    def status(self) -> V1Statuses:
        return V1Statuses(self.refresh()["status"])

    def get_statuses(self) -> list[dict]:
        return self.client.get(self._run_path("/statuses"))

    def get_metrics(self, names: Optional[list[str]] = None) -> dict:
        suffix = ""
        if names:
            suffix = "?" + "&".join(
                f"names={urllib.parse.quote(n)}" for n in names)
        return self.client.get(self._run_path("/metrics") + suffix)

    def get_events(self, kind: str = "metric",
                   names: Optional[list[str]] = None) -> dict:
        """Typed event streams (image/histogram/curve/confusion/...)."""
        params = [f"kind={urllib.parse.quote(kind)}"]
        params += [f"names={urllib.parse.quote(n)}" for n in (names or [])]
        return self.client.get(self._run_path("/events") + "?" + "&".join(params))

    def get_lineage(self) -> list:
        """Artifact lineage records (log_artifact/log_model history)."""
        return self.client.get(self._run_path("/lineage"))

    def get_outputs(self) -> dict:
        return self.client.get(self._run_path("/outputs"))

    def get_logs(self) -> str:
        path = (f"/streams/v1/{self.client.owner}/{self.project}/runs/"
                f"{self.run_uuid}/logs")
        return self.client.get(path)["logs"]

    def watch_logs(self) -> Iterator[str]:
        """SSE tail: yields log lines until the run finishes."""
        url = (f"{self.client.host}/streams/v1/{self.client.owner}/"
               f"{self.project}/runs/{self.run_uuid}/logs?follow=true")
        headers = ({"Authorization": f"Bearer {self.client.token}"}
                   if self.client.token else {})
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=None) as resp:
            for raw in resp:
                line = raw.decode()
                if line.startswith("event: done"):
                    return
                if line.startswith("data: "):
                    yield line[len("data: "):].rstrip("\n")

    def list_artifacts(self) -> list[str]:
        return self.client.get(self._run_path("/artifacts"))

    def download_artifact(self, rel: str, dest: str) -> str:
        quoted = urllib.parse.quote(rel)
        payload = self.client.get(self._run_path(f"/artifacts/{quoted}"), raw=True)
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        with open(dest, "wb") as fh:
            fh.write(payload)
        return dest

    # ------------------------------------------------------------- actions
    def stop(self, message: str = "") -> None:
        self.client.post(self._run_path("/stop"), body={"message": message})

    def restart(self, *, copy: bool = False) -> "RunClient":
        data = self.client.post(self._run_path("/restart"), body={"copy": copy})
        return RunClient(self.project, data["uuid"], client=self.client)

    def resume(self) -> "RunClient":
        data = self.client.post(self._run_path("/resume"))
        return RunClient(self.project, data["uuid"], client=self.client)

    # --------------------------------------------------------------- watch
    def wait(self, *, timeout: float = 600.0, poll_seconds: float = 0.5) -> V1Statuses:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.status
            if status in V1Statuses.terminal_values():
                return status
            time.sleep(poll_seconds)
        raise TimeoutError(f"run {self.run_uuid} not done within {timeout}s")
