"""Status notifiers (upstream `polyaxon/notifiers` — SURVEY.md §2:
slack/discord/pagerduty/webhook terminal-status pushes, §5.5).

Each notifier formats a terminal run status for one connection kind and
delivers it. Delivery is via stdlib urllib; the zero-egress test
environment uses ``FileNotifier`` (jsonl sink), which is also the audit
trail in production. The ``NotificationService`` resolves a run's
``notifications: [{connections: [...], trigger: ...}]`` spec against
the connection catalog and fans out on terminal transitions — wired
into the agent loop, not the store, so notification IO never blocks a
state transition.

Port of ``polyaxon_tpu/notifiers/service.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from typing import Any, Optional

from polyaxon_tpu_torch.connections import ConnectionCatalog, V1Connection, V1ConnectionKind
from polyaxon_tpu_torch.lifecycle import V1Statuses

logger = logging.getLogger(__name__)


def _payload(run: dict[str, Any], status: str) -> dict[str, Any]:
    return {
        "uuid": run.get("uuid"),
        "name": run.get("name"),
        "project": run.get("project"),
        "kind": run.get("kind"),
        "status": status,
        "finished_at": run.get("finished_at"),
        "ts": time.time(),
    }


class Notifier:
    kind = "abstract"

    def __init__(self, connection: V1Connection):
        self.connection = connection

    def format(self, run: dict[str, Any], status: str) -> dict[str, Any]:
        return _payload(run, status)

    def deliver(self, body: dict[str, Any]) -> None:
        raise NotImplementedError

    def notify(self, run: dict[str, Any], status: str) -> None:
        self.deliver(self.format(run, status))

    def _post(self, url: str, body: dict[str, Any],
              headers: Optional[dict[str, str]] = None) -> None:
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        with urllib.request.urlopen(req, timeout=10):
            pass


class WebhookNotifier(Notifier):
    kind = V1ConnectionKind.WEBHOOK

    def deliver(self, body: dict[str, Any]) -> None:
        url = (self.connection.schema_ or {}).get("url")
        if not url:
            raise ValueError(
                f"webhook connection `{self.connection.name}` has no url")
        self._post(url, body)


class SlackNotifier(WebhookNotifier):
    kind = V1ConnectionKind.SLACK

    def format(self, run: dict[str, Any], status: str) -> dict[str, Any]:
        emoji = {"succeeded": ":white_check_mark:", "failed": ":x:",
                 "stopped": ":octagonal_sign:"}.get(status, ":bell:")
        name = run.get("name") or run.get("uuid")
        return {
            "text": f"{emoji} Run *{name}* ({run.get('project')}) → *{status}*",
            "attachments": [{"fields": [
                {"title": "uuid", "value": run.get("uuid"), "short": True},
                {"title": "kind", "value": run.get("kind"), "short": True},
            ]}],
        }


class DiscordNotifier(WebhookNotifier):
    kind = V1ConnectionKind.DISCORD

    def format(self, run: dict[str, Any], status: str) -> dict[str, Any]:
        emoji = {"succeeded": "✅", "failed": "❌",
                 "stopped": "🛑"}.get(status, "🔔")
        name = run.get("name") or run.get("uuid")
        return {
            "content": f"{emoji} Run **{name}** ({run.get('project')}) → **{status}**",
            "embeds": [{"fields": [
                {"name": "uuid", "value": str(run.get("uuid")), "inline": True},
                {"name": "kind", "value": str(run.get("kind")), "inline": True},
            ]}],
        }


class PagerDutyNotifier(Notifier):
    kind = V1ConnectionKind.PAGERDUTY

    def format(self, run: dict[str, Any], status: str) -> dict[str, Any]:
        schema = self.connection.schema_ or {}
        return {
            "routing_key": schema.get("routing_key", ""),
            "event_action": "trigger",
            "payload": {
                "summary": f"run {run.get('name') or run.get('uuid')} {status}",
                "source": run.get("project") or "polyaxon-tpu",
                "severity": "error" if status == "failed" else "info",
                "custom_details": _payload(run, status),
            },
        }

    def deliver(self, body: dict[str, Any]) -> None:
        url = (self.connection.schema_ or {}).get(
            "url", "https://events.pagerduty.com/v2/enqueue")
        self._post(url, body)


class FileNotifier(Notifier):
    """Append-to-jsonl sink (custom kind with a path schema)."""

    kind = V1ConnectionKind.CUSTOM

    def deliver(self, body: dict[str, Any]) -> None:
        path = (self.connection.schema_ or {}).get("path")
        if not path:
            raise ValueError(
                f"file notifier `{self.connection.name}` has no path")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as fh:
            fh.write(json.dumps(body) + "\n")


_NOTIFIERS = {
    V1ConnectionKind.WEBHOOK: WebhookNotifier,
    V1ConnectionKind.SLACK: SlackNotifier,
    V1ConnectionKind.DISCORD: DiscordNotifier,
    V1ConnectionKind.PAGERDUTY: PagerDutyNotifier,
    V1ConnectionKind.CUSTOM: FileNotifier,
}

_TRIGGER_MATCH = {
    None: lambda s: True,
    "done": lambda s: True,
    "succeeded": lambda s: s == V1Statuses.SUCCEEDED,
    "failed": lambda s: s in (V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED),
    "stopped": lambda s: s == V1Statuses.STOPPED,
}


class NotificationService:
    def __init__(self, catalog: ConnectionCatalog):
        self.catalog = catalog

    def notifier_for(self, name: str) -> Notifier:
        connection = self.catalog.get(name)
        cls = _NOTIFIERS.get(connection.kind)
        if cls is None:
            raise ValueError(
                f"connection `{name}` (kind={connection.kind}) cannot notify")
        return cls(connection)

    def notify_terminal(self, run: dict[str, Any], status: V1Statuses,
                        notifications: list[dict[str, Any]]) -> int:
        """Fan out; returns deliveries. Failures log, never raise."""
        sent = 0
        for spec in notifications or []:
            trigger = (spec.get("trigger") or "done").lower()
            matcher = _TRIGGER_MATCH.get(trigger)
            if matcher is None or not matcher(status):
                continue
            for name in spec.get("connections") or []:
                try:
                    self.notifier_for(name).notify(run, status.value)
                    sent += 1
                except Exception as exc:
                    logger.warning("notification via `%s` failed: %s", name, exc)
        return sent
