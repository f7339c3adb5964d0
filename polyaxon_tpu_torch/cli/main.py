"""``plx-torch``: the port's CLI (port of ``polyaxon_tpu/cli/main.py``).

The same command tree, options and printed output as ``plx``, over the
port's control plane, agent, API server, client and serving. State
lives under ``$POLYAXON_TPU_HOME`` (default ``~/.polyaxon_tpu``), as the
reference's does.

Where it differs:

- ``run``, ``server``, ``agent`` and ``serve`` take ``--device`` (the
  card by default; ``--device cpu`` for the CPU). It is where an
  in-process run trains (``run -w``), the device of the agent's executor,
  and the device ``serve`` loads the model on; a subprocess gang runs its
  plan's command, the port's launcher, on the card. ``plx`` moves to the
  CPU with ``JAX_PLATFORMS=cpu``; this CLI reads no environment variable
  that does so.
- ``--slice NAME:N`` registers a GPU host's N cards as a slice; a run's
  ``topology: "k"`` asks for k of them, and the cards the pool places it
  on are the only ones its processes hold (``agent/slices.py``).
- ``convert --from-hf`` writes the port's checkpoint store (what
  ``serve --checkpoint`` reads); ``convert --from-orbax`` keeps its name
  but exports the port's own train state (LoRA adapters merged) to HF
  safetensors and ``config.json``. A real Orbax directory of the JAX
  package goes through ``scripts/convert_orbax_to_torch.py`` first.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import click

from polyaxon_tpu_torch.tracking.events import V1EventKind as _V1EventKind

DEFAULT_HOME = os.path.join(os.path.expanduser("~"), ".polyaxon_tpu")


def get_home() -> str:
    return os.environ.get("POLYAXON_TPU_HOME", DEFAULT_HOME)


def get_plane():
    from polyaxon_tpu_torch.controlplane import ControlPlane

    return ControlPlane(get_home())


def get_run_or_fail(plane, uid):
    try:
        return plane.get_run(uid)
    except KeyError as exc:
        raise click.ClickException(str(exc.args[0])) from exc


def _parse_params(params: tuple[str, ...]) -> dict:
    out = {}
    for item in params:
        if "=" not in item:
            raise click.BadParameter(f"-P expects name=value, got `{item}`")
        name, raw = item.split("=", 1)
        try:
            out[name] = json.loads(raw)
        except json.JSONDecodeError:
            out[name] = raw
    return out


def _echo_run(record, verbose: bool = False) -> None:
    status = record.status.value if hasattr(record.status, "value") else record.status
    click.echo(f"{record.uuid}  {status:12s}  {record.kind or '-':10s}  "
               f"{record.project}/{record.name or '-'}")
    if verbose and record.meta:
        click.echo(f"  meta: {json.dumps(record.meta)[:200]}")


_DEVICE_HELP = ("torch device to run on (default: the card, cuda; "
                "'cpu' runs on the CPU)")


@click.group()
def cli():
    """polyaxon_tpu_torch: the PyTorch/CUDA port's orchestration CLI."""


# ------------------------------------------------------------------- config
@cli.group("config")
def config_group():
    """Client configuration (~/.polyaxon_tpu/config.json)."""


def _read_json_or_empty(path: str) -> dict:
    if os.path.exists(path):
        try:
            with open(path) as fh:
                return json.load(fh)
        except (OSError, json.JSONDecodeError):
            return {}
    return {}


@config_group.command("set")
@click.option("--host", default=None, help="API host, e.g. http://plx:8000")
@click.option("--token", default=None,
              help="bearer token for an auth-enabled server "
                   "(plx server --auth-token/--owner-token)")
@click.argument("pairs", nargs=-1)
def config_set(host, token, pairs):
    """Set client host/token and/or home config key=value PAIRS."""
    from polyaxon_tpu_torch.client.client import CONFIG_DIR, CONFIG_FILE

    out = {}
    if host or token:
        os.makedirs(CONFIG_DIR, exist_ok=True)
        data = _read_json_or_empty(CONFIG_FILE)
        if host:
            data["host"] = host
        if token:
            data["token"] = token
        with open(CONFIG_FILE, "w") as fh:
            json.dump(data, fh, indent=2)
        out["client"] = data
    if pairs:
        path = os.path.join(get_home(), "config.json")
        cfg = _read_json_or_empty(path)
        for item in pairs:
            key, _, value = item.partition("=")
            cfg[key] = value
        os.makedirs(get_home(), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(cfg, fh, indent=2)
        out["home"] = cfg
    click.echo(json.dumps(out, indent=2))


@config_group.command("show")
def config_show():
    from polyaxon_tpu_torch.client.client import CONFIG_FILE, resolve_host

    click.echo(json.dumps({
        "client_file": CONFIG_FILE,
        "client": _read_json_or_empty(CONFIG_FILE),
        "home": _read_json_or_empty(os.path.join(get_home(), "config.json")),
        "resolved_host": resolve_host(),
    }, indent=2))


# ---------------------------------------------------------------------- run
@cli.command()
@click.option("-f", "--polyaxonfile", "files", multiple=True, type=click.Path(),
              help="Polyaxonfile path(s); later files patch earlier ones.")
@click.option("-P", "--param", "params", multiple=True, help="name=value override")
@click.option("--preset", "presets", multiple=True, help="preset file/name to apply")
@click.option("-p", "--project", default="default")
@click.option("--name", default=None)
@click.option("--hub", default=None, help="hub component ref")
@click.option("-w", "--watch", is_flag=True, help="execute locally and stream status")
@click.option("--eager", is_flag=True, help="alias for --watch")
@click.option("-u", "--upload", is_flag=True, hidden=True)
@click.option("--device", default=None, help=_DEVICE_HELP)
def run(files, params, presets, project, name, hub, watch, eager, upload,
        device):
    """Submit an operation (optionally executing it to completion)."""
    from polyaxon_tpu_torch.polyaxonfile import PolyaxonfileError

    plane = get_plane()
    try:
        record = plane.submit(
            list(files) if files else None,
            project=project,
            params=_parse_params(params),
            presets=list(presets) or None,
            name=name,
        )
    except (PolyaxonfileError, ValueError) as exc:
        raise click.ClickException(str(exc)) from exc
    click.echo(f"Run created: {record.uuid} (project={project})")
    if watch or eager:
        from polyaxon_tpu_torch.agent import Agent

        agent = Agent(plane, in_process=True, device=device)
        click.echo("Executing locally...")
        last = None
        deadline = time.monotonic() + 24 * 3600
        while time.monotonic() < deadline:
            agent.reconcile_once()
            current = plane.get_run(record.uuid)
            if current.status != last:
                click.echo(f"  status: {current.status.value}")
                last = current.status
            if current.is_done:
                children = plane.list_runs(pipeline_uuid=record.uuid)
                if all(c.is_done for c in children):
                    break
            time.sleep(0.3)
        outputs = plane.streams.get_outputs(record.uuid)
        if outputs:
            click.echo("outputs: " + json.dumps(outputs, indent=2, default=str))
        sys.exit(0 if plane.get_run(record.uuid).status.value == "succeeded" else 1)


# ---------------------------------------------------------------------- ops
@cli.group()
def ops():
    """Inspect and manage runs."""


@ops.command("ls")
@click.option("-p", "--project", default=None)
@click.option("--status", default=None)
@click.option("--limit", default=50)
@click.option("--pipeline", default=None,
              help="only children of this sweep/DAG uuid")
def ops_ls(project, status, limit, pipeline):
    from polyaxon_tpu_torch.lifecycle import V1Statuses

    plane = get_plane()
    statuses = [V1Statuses(status)] if status else None
    for record in plane.list_runs(project=project, statuses=statuses,
                                  limit=limit, pipeline_uuid=pipeline):
        _echo_run(record)


@ops.command("trials")
@click.option("-uid", "--uid", required=True, help="sweep (matrix) run uuid")
def ops_trials(uid):
    """Sweep trials grouped by bracket/rung, best metric first — the
    CLI twin of the dashboard's bracket view."""
    plane = get_plane()
    record = get_run_or_fail(plane, uid)
    # Explicit limit: the store defaults to 1000 and a big sweep's table
    # must never silently drop (possibly the best) trials.
    children = plane.list_runs(pipeline_uuid=record.uuid, limit=1_000_000)
    if not children:
        click.echo("no trials yet")
        return
    matrix = (record.spec or {}).get("matrix") or {}
    metric = (matrix.get("metric") or {}).get("name")
    maximize = (matrix.get("metric") or {}).get("optimization") == "maximize"
    groups: dict[tuple, list] = {}
    for child in children:
        meta = child.meta or {}
        key = (meta.get("bracket"), meta.get("rung"))
        value = plane.get_metric(child.uuid, metric) if metric else None
        groups.setdefault(key, []).append((child, value))
    for key in sorted(groups, key=lambda k: (k[0] is None, k)):
        bracket, rung = key
        label = (f"bracket {bracket} rung {rung}"
                 if bracket is not None else "trials")
        click.echo(f"{label}:")
        trials = sorted(  # best first; metric-less rows last
            groups[key],
            key=lambda t: (t[1] is None,
                           0 if t[1] is None
                           else (-t[1] if maximize else t[1])))
        for child, value in trials:
            params = (child.meta or {}).get("trial_params") or {}
            pstr = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in params.items())
            vstr = f"{value:.6g}" if value is not None else "-"
            click.echo(f"  {child.uuid[:12]}  {child.status.value:10s} "
                       f"{vstr:>12s}  {pstr}")


@ops.command("get")
@click.option("-uid", "--uid", required=True)
def ops_get(uid):
    plane = get_plane()
    record = get_run_or_fail(plane, uid)
    data = {
        "uuid": record.uuid, "project": record.project, "name": record.name,
        "kind": record.kind, "status": record.status.value,
        "created_at": record.created_at, "finished_at": record.finished_at,
        "meta": record.meta, "params": record.params,
    }
    click.echo(json.dumps(data, indent=2, default=str))


@ops.command("statuses")
@click.option("-uid", "--uid", required=True)
def ops_statuses(uid):
    plane = get_plane()
    for cond in plane.get_statuses(uid):
        click.echo(f"{cond['created_at']}  {cond['type']:16s} "
                   f"{cond.get('reason') or ''} {cond.get('message') or ''}")


def _render_timeline(timeline) -> None:
    """Span-tree waterfall shared by the run timeline and the serving
    request timeline (both are obs.trace.build_timeline output)."""
    t0 = timeline["t0"]
    click.echo(f"trace {timeline['trace_id']}  "
               f"spans={timeline['span_count']}  "
               f"wall={timeline['duration_ms']/1e3:.2f}s")

    def fmt_attrs(attrs):
        keep = {k: v for k, v in (attrs or {}).items() if v is not None}
        return (" " + " ".join(f"{k}={v}" for k, v in keep.items())
                if keep else "")

    def walk(node, depth):
        offset_ms = (node["start"] - t0) * 1e3
        marker = "!" if node.get("status") == "error" else " "
        click.echo(
            f"{marker} {'  ' * depth}{node['name']:<14} "
            f"+{offset_ms:9.1f}ms {node['duration_ms']:10.1f}ms"
            f"{fmt_attrs(node.get('attributes'))}"
            + (f"  [{node['error']}]" if node.get("error") else ""))
        for event in node.get("events") or []:
            ev_off = ((event.get("time") or node["start"]) - t0) * 1e3
            click.echo(f"  {'  ' * depth}* {event['name']} "
                       f"+{ev_off:.1f}ms{fmt_attrs(event.get('attributes'))}")
        for child in node.get("children") or []:
            walk(child, depth + 1)

    for root in timeline["spans"]:
        walk(root, 0)
    for event in timeline.get("events") or []:
        ev_off = ((event.get("time") or t0) - t0) * 1e3
        click.echo(f"* {event['name']} +{ev_off:.1f}ms"
                   f"{fmt_attrs(event.get('attributes'))}")


@ops.command("timeline")
@click.option("-uid", "--uid", required=True)
@click.option("--json", "as_json", is_flag=True,
              help="raw span tree instead of the waterfall rendering")
def ops_timeline(uid, as_json):
    """Run-lifecycle waterfall: the ordered span tree —
    compile → admission → placement → execute → runtime steps →
    checkpoint → sidecar sync — with chaos faults and retries as
    annotated events, so a slow or chaos-drilled run explains itself."""
    plane = get_plane()
    get_run_or_fail(plane, uid)
    timeline = plane.timeline(uid)
    if as_json:
        click.echo(json.dumps(timeline, indent=2, default=str))
        return
    if not timeline["spans"]:
        click.echo("(no lifecycle spans recorded for this run yet)")
        return
    _render_timeline(timeline)


@ops.command("request-timeline")
@click.option("--url", default="http://127.0.0.1:8080",
              help="serving server base URL")
@click.option("-id", "--id", "request_id", default=None,
              help="request id (a generate response's request_ids, or "
                   "pick one from the listing this prints when omitted)")
@click.option("--json", "as_json", is_flag=True,
              help="raw payload instead of the rendered waterfall")
def ops_request_timeline(url, request_id, as_json):
    """Per-request serving waterfall: one request's span
    tree — queue_wait → prefill (chunk events) → decode (first_token /
    spec_round / eviction events) — fetched from a live serving
    server's bounded trace ring, with the phase/TTFT summary on top.
    Without --id, lists the ring's recent requests instead."""
    import urllib.error
    import urllib.request

    base = url.rstrip("/")
    target = (f"{base}/requests/{request_id}/timeline"
              if request_id else f"{base}/requests")
    try:
        with urllib.request.urlopen(target, timeout=10) as resp:
            payload = json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        detail = exc.read().decode(errors="replace")
        try:
            detail = json.loads(detail).get("error", detail)
        except (json.JSONDecodeError, AttributeError):
            pass
        raise click.ClickException(f"HTTP {exc.code} from {target}: {detail}")
    except (urllib.error.URLError, OSError) as exc:
        raise click.ClickException(f"cannot reach {target}: {exc}")
    if as_json:
        click.echo(json.dumps(payload, indent=2, default=str))
        return
    if request_id is None:
        requests = payload.get("requests") or []
        if not requests:
            click.echo("(no traced requests in the ring yet)")
            return
        for row in requests:
            state = row.get("phase") or (
                "done" if row.get("done") else "pending")
            click.echo(f"{row['request_id']}  {row.get('class') or '-':<10} "
                       f"{state:<10} {row.get('status') or ''}"
                       + (f"  [{row['error']}]" if row.get("error") else ""))
        return
    summary = payload.get("summary") or {}
    if summary:
        phases = " ".join(f"{name}={ms}ms" for name, ms
                          in (summary.get("phases_ms") or {}).items())
        cached = summary.get("prefix_cached_tokens")
        click.echo(f"request {summary.get('request_id')}  "
                   f"class={summary.get('class')}  "
                   f"status={summary.get('status')}  "
                   f"ttft={summary.get('ttft_ms')}ms  "
                   f"tokens={summary.get('tokens_out')}"
                   + (f"  prefix_cached={cached}" if cached else "")
                   + f"  {phases}")
    _render_timeline(payload)


@ops.command("fleet")
@click.option("--url", default="http://127.0.0.1:8080",
              help="serving server base URL")
@click.option("--json", "as_json", is_flag=True,
              help="raw payload instead of the rendered breakdown")
def ops_fleet(url, as_json):
    """Fleet telemetry breakdown: per-replica TTFT
    p50/p99, preemption totals, and the cross-replica skew ratio read
    from the component-scoped metric series of a live fleet server's
    ``/v1/fleet``, plus replica states and routing decisions."""
    import urllib.error
    import urllib.request

    target = url.rstrip("/") + "/v1/fleet"
    try:
        with urllib.request.urlopen(target, timeout=10) as resp:
            payload = json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        detail = exc.read().decode(errors="replace")
        try:
            detail = json.loads(detail).get("error", detail)
        except (json.JSONDecodeError, AttributeError):
            pass
        raise click.ClickException(f"HTTP {exc.code} from {target}: {detail}")
    except (urllib.error.URLError, OSError) as exc:
        raise click.ClickException(f"cannot reach {target}: {exc}")
    if as_json:
        click.echo(json.dumps(payload, indent=2, default=str))
        return
    stats = payload.get("stats") or {}
    states = stats.get("states") or {}
    skew = payload.get("ttft_skew")
    click.echo("fleet: "
               + " ".join(f"{s}={n}" for s, n in states.items() if n)
               + (f"  ttft_skew={skew:.2f}" if skew is not None else "")
               + f"  hit_rate={stats.get('prefix_hit_rate')}")
    router = stats.get("router") or {}
    if router.get("routed"):
        click.echo("routed: " + " ".join(
            f"{k}={v}" for k, v in sorted(router["routed"].items())))
    per_replica = payload.get("per_replica") or {}
    replicas = stats.get("replicas") or {}
    for rid in sorted(set(per_replica) | set(replicas)):
        t = per_replica.get(rid) or {}
        r = replicas.get(rid) or {}
        click.echo(f"{rid:<6} {r.get('state') or '-':<9} "
                   f"served={r.get('served', 0):<5} "
                   f"ttft_p50={t.get('ttft_p50_ms')}ms "
                   f"p99={t.get('ttft_p99_ms')}ms "
                   f"preemptions={t.get('preemptions', 0)}")


@ops.command("report")
@click.option("-uid", "--uid", required=True)
@click.option("--json", "as_json", is_flag=True,
              help="raw report instead of the rendered tables")
def ops_report(uid, as_json):
    """Performance attribution report: where the run's wall
    clock went (compile / input-wait / step / checkpoint / restore /
    sync ...), whether step time drifted (rolling-median/MAD anomaly
    flags), and which phases absorbed retries, chaos faults, and
    requeues — a regression arrives pre-attributed."""
    plane = get_plane()
    get_run_or_fail(plane, uid)
    report = plane.report(uid)
    if as_json:
        click.echo(json.dumps(report, indent=2, default=str))
        return
    click.echo(f"run {report['run_uuid']}  status={report['status']}  "
               f"attempts={report['attempts']}  "
               f"wall={report['wall_clock_ms'] / 1e3:.2f}s  "
               f"(phases sum {report['phase_sum_ms'] / 1e3:.2f}s)")
    for name, entry in report["phases"].items():
        extra = ""
        if name == "restore":
            # Tier/culling audit: which tier answered each
            # restore and which corrupt steps the fallback skipped.
            if entry.get("tiers"):
                extra += "  tiers " + " ".join(
                    f"{t}:{n}" for t, n in entry["tiers"].items())
            if entry.get("skipped_steps"):
                extra += (f"  skipped={entry['skipped_steps']}")
        frac = (f"{entry['fraction'] * 100:5.1f}%"
                if entry["fraction"] is not None else "    -")
        click.echo(f"  {name:<13} {entry['ms']:>10.1f}ms  {frac}"
                   f"  x{entry['count']}{extra}")
    steps = report["steps"]
    if steps["windows"]:
        click.echo(f"step windows: {len(steps['windows'])}  "
                   f"rolling median {steps['rolling_median_ms']}ms  "
                   f"anomalies {len(steps['anomalies'])}")
        for anom in steps["anomalies"]:
            click.echo(f"  ! step<={anom['to_step']} "
                       f"{anom['step_time_ms']}ms vs median "
                       f"{anom['median_ms']}ms "
                       f"({anom['deviation_sigmas']:+.1f} sigma)")
    notes = report["annotations"]
    for kind in ("retries", "chaos", "requeues"):
        if notes.get(kind):
            pairs = " ".join(f"{k}={v}" for k, v in notes[kind].items())
            click.echo(f"{kind}: {pairs}")
    for alert in report.get("alerts") or []:
        click.echo(f"alert: {alert['rule']} ({alert['severity']}) "
                   f"fired on this run")


@ops.command("verify")
@click.option("-uid", "--uid", default=None,
              help="scope the run-surface invariants to one run "
                   "(fleet-wide when omitted)")
@click.option("--json", "as_json", is_flag=True)
def ops_verify(uid, as_json):
    """Telemetry-oracle verdicts: the committed invariant
    set (obs/oracle.json) judged against the plane's end state — run
    terminal statuses, phase accounting, metric/SLO predicates, loss
    continuity, and unresolved alerts — with the offending
    run/series/alert attached as evidence. Exits nonzero on any
    failed invariant."""
    plane = get_plane()
    if uid is not None:
        get_run_or_fail(plane, uid)
    result = plane.verify(uid)
    if as_json:
        click.echo(json.dumps(result, indent=2, default=str))
    else:
        for verdict in result["verdicts"]:
            marker = {"pass": "ok  ", "skip": "skip",
                      "fail": "FAIL"}[verdict["verdict"]]
            line = f"  [{marker}] {verdict['invariant']}"
            if verdict["verdict"] != "pass":
                line += ("  "
                         + json.dumps(verdict["evidence"],
                                      default=str)[:160])
            click.echo(line)
        counts = result["counts"]
        click.echo(f"verdicts: {counts['pass']} pass / "
                   f"{counts['fail']} fail / {counts['skip']} skip")
    if not result["passed"]:
        raise SystemExit(1)


@ops.command("alerts")
@click.option("--json", "as_json", is_flag=True)
@click.option("--all", "show_all", is_flag=True,
              help="every rule's state, not just firing alerts")
@click.option("--since", default=None, metavar="WINDOW",
              help="bound history to the last WINDOW (e.g. 15m, 2h)")
@click.option("--limit", default=None, type=int, metavar="N",
              help="at most N most-recent history events")
def ops_alerts(as_json, show_all, since, limit):
    """Alert-rule state over the live registry: the committed
    ruleset (obs/rules.json) evaluated now — firing alerts first, then
    (with --all) every rule's current value vs its threshold. History
    (fired/resolved transitions) is bounded by --since/--limit."""
    import time as _time

    from polyaxon_tpu_torch.obs import rules as obs_rules

    plane = get_plane()
    engine = obs_rules.default_engine()
    engine.evaluate(plane=plane)
    payload = engine.to_json()
    if since is not None:
        try:
            horizon = _time.time() - obs_rules.parse_window(
                since, field_name="--since")
        except obs_rules.RuleError as exc:
            raise click.UsageError(str(exc))
        payload["history"] = [e for e in payload["history"]
                              if float(e.get("at") or 0) >= horizon]
    if limit is not None:
        if limit < 0:
            raise click.UsageError("--limit must be >= 0")
        payload["history"] = payload["history"][-limit:] if limit else []
    if as_json:
        click.echo(json.dumps(payload, indent=2, default=str))
        return
    if not payload["alerts"]:
        click.echo("no firing alerts")
    for alert in payload["alerts"]:
        click.echo(f"FIRING [{alert['severity']}] {alert['rule']}: "
                   f"value={alert['value']} threshold={alert['threshold']}"
                   f"  {alert['description']}")
    if show_all:
        for rule in payload["rules"]:
            click.echo(f"  {rule['state']:<9} {rule['rule']:<24} "
                       f"{rule['metric']} value={rule['value']} "
                       f"threshold={rule['threshold']}")
    if since is not None or limit is not None:
        click.echo(f"history ({len(payload['history'])} event(s)):")
        for event in payload["history"]:
            click.echo(f"  {event.get('event'):<9} {event.get('rule')}"
                       f"  at={event.get('at')}")


_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _sparkline(values):
    lo, hi = min(values), max(values)
    if hi - lo < 1e-12:
        return _SPARK_GLYPHS[0] * len(values)
    scale = (len(_SPARK_GLYPHS) - 1) / (hi - lo)
    return "".join(_SPARK_GLYPHS[int((v - lo) * scale)] for v in values)


def _point_scalar(sample):
    # Histogram points carry the cumulative sample dict; plot the count.
    if isinstance(sample, dict):
        return float(sample.get("count") or 0.0)
    return float(sample)


@ops.command("history")
@click.argument("metric", required=False)
@click.option("--window", default=None, metavar="WINDOW",
              help="scope to a marked window name (e.g. storm) or a "
                   "trailing span (e.g. 15m)")
@click.option("--labels", "labels_raw", default=None, metavar="K=V[,K=V]",
              help="pick one labeled series of the family")
@click.option("--json", "as_json", is_flag=True)
def ops_history(metric, window, labels_raw, as_json):
    """Sampled metrics history (obs.history): the bounded ring the
    alert engine and the telemetry oracle share. Without METRIC, lists
    the sampled families; with one, renders each series as a sparkline
    over the selected scope (a marked window or a trailing span)."""
    from polyaxon_tpu_torch.obs import history as obs_history
    from polyaxon_tpu_torch.obs import rules as obs_rules

    plane = get_plane()
    # Evaluating the default engine force-samples the shared ring, so a
    # fresh process still answers with at least the current instant.
    obs_rules.default_engine().evaluate(plane=plane)
    labels = None
    if labels_raw:
        labels = {}
        for part in labels_raw.split(","):
            key, sep, value = part.partition("=")
            if not sep or not key.strip():
                raise click.UsageError(
                    f"bad --labels selector {labels_raw!r} "
                    "(want k=v[,k2=v2])")
            labels[key.strip()] = value.strip()
    try:
        payload = obs_history.query_history(
            obs_history.default_history().to_json(),
            name=metric, window=window, labels=labels)
    except ValueError as exc:
        raise click.UsageError(str(exc))
    if as_json:
        click.echo(json.dumps(payload, indent=2, default=str))
        return
    cov = payload.get("coverage") or {}
    span = ((float(cov["end"]) - float(cov["start"]))
            if cov.get("start") is not None else 0.0)
    click.echo(f"coverage: {cov.get('samples', 0)} sample(s) over "
               f"{span:.1f}s; cadence {payload.get('cadence')}s")
    scope = payload.get("scope")
    if scope:
        click.echo(f"scope: {scope['window']} "
                   f"[{scope['start']:.3f} .. {scope['end']:.3f}]")
    if metric is None:
        for name in payload.get("metrics") or []:
            click.echo(f"  {name}")
        return
    family = payload["metric"]
    for key, points in sorted(family["series"].items()):
        values = [_point_scalar(p[1]) for p in points]
        label = key if key else "(no labels)"
        if not values:
            click.echo(f"  {label}: no points in scope")
            continue
        click.echo(f"  {label}: {_sparkline(values)}  "
                   f"last={values[-1]:g} n={len(values)}")


@ops.command("logs")
@click.option("-uid", "--uid", required=True)
@click.option("--follow", is_flag=True)
def ops_logs(uid, follow):
    plane = get_plane()
    names = plane.streams.log_files(uid)
    if not names:
        click.echo("(no logs)")
        return
    offsets = {}
    for name in names:
        chunk, offsets[name] = plane.streams.read_logs(uid, name)
        if chunk:
            click.echo(chunk, nl=False)
    if follow:
        record = get_run_or_fail(plane, uid)

        def done():
            return plane.get_run(uid).is_done

        if not record.is_done:
            for chunk in plane.streams.follow_logs(
                uid, names[0], should_stop=done, offset=offsets[names[0]]
            ):
                click.echo(chunk, nl=False)


@ops.command("outputs")
@click.option("-uid", "--uid", required=True)
def ops_outputs(uid):
    plane = get_plane()
    click.echo(json.dumps(plane.streams.get_outputs(uid), indent=2, default=str))


@ops.command("artifacts")
@click.option("-uid", "--uid", required=True)
@click.option("--download", "download_rel", default=None,
              help="run-relative artifact path to copy out")
@click.option("-o", "--output", default=".",
              help="(with --download) destination file or directory")
def ops_artifacts(uid, download_rel, output):
    import shutil

    plane = get_plane()
    if download_rel:
        try:
            src = plane.streams.artifact_path(uid, download_rel)
        except ValueError as exc:  # traversal guard → clean CLI error
            raise click.ClickException(str(exc)) from exc
        if not os.path.isfile(src):
            raise click.ClickException(f"artifact not found: {download_rel}")
        dest = output
        # A trailing slash or an existing dir both mean "into this dir".
        if os.path.isdir(dest) or dest.endswith(os.sep):
            dest = os.path.join(dest, os.path.basename(download_rel))
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        shutil.copy2(src, dest)
        click.echo(dest)
        return
    for rel in plane.streams.list_artifacts(uid):
        click.echo(rel)


@ops.command("metrics")
@click.option("-uid", "--uid", required=True)
@click.option("--name", "names", multiple=True)
def ops_metrics(uid, names):
    plane = get_plane()
    metrics = plane.streams.get_metrics(uid, list(names) or None)
    click.echo(json.dumps(metrics, indent=2, default=str))


@ops.command("compare")
@click.argument("uids", nargs=-1, required=True)
@click.option("--metric", "metric_names", multiple=True,
              help="metric(s) to tabulate (default: the union across "
                   "the runs; absent values print '-')")
def ops_compare(uids, metric_names):
    """Side-by-side comparison of N runs — the CLI twin of the
    dashboard's compare view: final value of each metric per run, plus
    the params whose values DIFFER across the selection."""
    if len(uids) < 2:
        raise click.BadParameter("give at least two run uuids")
    plane = get_plane()
    records = [get_run_or_fail(plane, uid) for uid in uids]
    labels = [r.name or r.uuid[:12] for r in records]

    def vals_of(record):
        out = {}
        for key, value in (record.params or {}).items():
            if isinstance(value, dict) and "value" in value:
                value = value["value"]
            out[key] = value
        out.update((record.meta or {}).get("trial_params") or {})
        return out

    per_run = [vals_of(r) for r in records]
    keys = sorted({k for vals in per_run for k in vals})
    differing = [k for k in keys
                 if len({json.dumps(v.get(k), sort_keys=True, default=str)
                         for v in per_run}) > 1]

    def fmt(v):
        if v is None:
            return "-"
        return f"{v:.6g}" if isinstance(v, float) else str(v)

    width = max([len(x) for x in labels] + [12])
    header = "  ".join(f"{name:>{width}}" for name in labels)
    click.echo(f"  {'':>20s}  {header}")
    if differing:
        click.echo("differing params:")
        for k in differing:
            cells = "  ".join(f"{fmt(v.get(k)):>{width}}" for v in per_run)
            click.echo(f"  {k:>20s}  {cells}")
    all_metrics = metric_names or sorted(
        set().union(*[plane.streams.metric_names(r.uuid) for r in records]))
    if all_metrics:
        click.echo("final metrics:")
        for name in all_metrics:
            row = [fmt(plane.streams.last_metric(r.uuid, name))
                   for r in records]
            cells = "  ".join(f"{v:>{width}}" for v in row)
            click.echo(f"  {name:>20s}  {cells}")


@ops.command("events")
@click.option("-uid", "--uid", required=True)
@click.option("--kind", default="metric",
              type=click.Choice(sorted(_V1EventKind.VALUES)))
@click.option("--name", "names", multiple=True)
def ops_events(uid, kind, names):
    plane = get_plane()
    events = plane.streams.get_events(uid, kind, list(names) or None)
    click.echo(json.dumps(events, indent=2, default=str))


@ops.command("lineage")
@click.option("-uid", "--uid", required=True)
@click.option("--graph", is_flag=True,
              help="cross-run inputs → run → outputs graph (param "
                   "refs, DAG deps, joins, cache adoption) instead of "
                   "this run's artifact records")
def ops_lineage(uid, graph):
    plane = get_plane()
    if graph:
        get_run_or_fail(plane, uid)  # clean CLI error on unknown uid
        data = plane.lineage_graph(uid)
        by_uuid = {n["uuid"]: n for n in data["nodes"]}

        def label(u):
            n = by_uuid.get(u) or {}
            return f"{n.get('name') or u[:8]} [{n.get('status', '?')}]"

        for e in data["edges"]:
            tag = e["kind"] + (f":{e['label']}" if e.get("label") else "")
            click.echo(f"{label(e['from'])} --{tag}--> {label(e['to'])}")
        for a in data["artifacts"]:
            click.echo(f"{label(uid)} --artifact--> "
                       f"{a.get('kind', 'artifact')}:{a.get('name')}")
        for k in data["outputs"]:
            click.echo(f"{label(uid)} --output--> {k}")
        if not (data["edges"] or data["artifacts"] or data["outputs"]):
            click.echo("(no lineage edges recorded)")
        return
    click.echo(json.dumps(plane.streams.get_lineage(uid), indent=2,
                          default=str))


@ops.command("stop")
@click.option("-uid", "--uid", required=True)
def ops_stop(uid):
    plane = get_plane()
    plane.stop(uid)
    click.echo(f"Stop requested for {uid}")


@ops.command("restart")
@click.option("-uid", "--uid", required=True)
@click.option("--copy", is_flag=True)
def ops_restart(uid, copy):
    plane = get_plane()
    record = plane.restart(uid, copy=copy)
    click.echo(f"Restarted as {record.uuid}")


@ops.command("resume")
@click.option("-uid", "--uid", required=True)
def ops_resume(uid):
    plane = get_plane()
    try:
        record = plane.resume(uid)
    except ValueError as exc:
        raise click.ClickException(str(exc)) from exc
    click.echo(f"Resumed {record.uuid}")


# ------------------------------------------------------------------ project
@cli.group()
def projects():
    """Manage projects."""


@projects.command("create")
@click.option("--name", required=True)
@click.option("--description", default="")
def projects_create(name, description):
    plane = get_plane()
    plane.store.create_project(name, description)
    click.echo(f"Project `{name}` created")


@projects.command("ls")
def projects_ls():
    plane = get_plane()
    for proj in plane.store.list_projects():
        click.echo(f"{proj['name']}  {proj.get('description') or ''}")


# -------------------------------------------------------------- scheduling
@cli.group("queue")
def queue_group():
    """Manage scheduling queues (docs/scheduling.md)."""


@queue_group.command("ls")
def queue_ls():
    """List queues with priority, caps, and live depth/usage."""
    plane = get_plane()
    stats = plane.scheduling_stats()
    click.echo(f"{'NAME':16s} {'PRIO':>4s} {'CAP':>4s} {'SPOT':>4s} "
               f"{'DEPTH':>5s} {'RUNNING':>7s}")
    for queue in stats["queues"]:
        cap = queue["concurrency"]
        click.echo(f"{queue['name']:16s} {queue['priority']:>4d} "
                   f"{('-' if cap is None else str(cap)):>4s} "
                   f"{('yes' if queue['preemptible'] else 'no'):>4s} "
                   f"{queue['depth']:>5d} {queue['running']:>7d}")


@queue_group.command("add")
@click.argument("name")
@click.option("--priority", default=0, help="higher admits (and evicts) first")
@click.option("--concurrency", default=None, type=int,
              help="max concurrent runs admitted from this queue")
@click.option("--preemptible", is_flag=True,
              help="runs admitted here may be evicted for higher-priority work")
@click.option("--description", default="")
def queue_add(name, priority, concurrency, preemptible, description):
    """Create or update a queue."""
    plane = get_plane()
    queue = plane.upsert_queue(name, priority=priority,
                               concurrency=concurrency,
                               preemptible=preemptible,
                               description=description)
    click.echo(json.dumps(queue, indent=2, default=str))


@queue_group.command("rm")
@click.argument("name")
def queue_rm(name):
    plane = get_plane()
    try:
        removed = plane.delete_queue(name)
    except ValueError as exc:
        raise click.ClickException(str(exc)) from exc
    if not removed:
        raise click.ClickException(f"queue `{name}` not found")
    click.echo(f"Queue `{name}` removed")


@queue_group.command("inspect")
@click.argument("name")
def queue_inspect(name):
    """One queue's config + depth + the runs currently queued/live on it."""
    from polyaxon_tpu_torch.lifecycle import V1Statuses
    from polyaxon_tpu_torch.scheduling import LIVE_STATUSES, sched_info

    plane = get_plane()
    stats = plane.scheduling_stats()
    queue = next((q for q in stats["queues"] if q["name"] == name), None)
    if queue is None:
        raise click.ClickException(f"queue `{name}` not found")
    click.echo(json.dumps(queue, indent=2, default=str))
    rows = plane.list_runs(statuses=[V1Statuses.QUEUED] + LIVE_STATUSES)
    members = [r for r in rows if sched_info(r).queue == name]
    if members:
        click.echo("runs:")
        for record in members:
            _echo_run(record)


@cli.group("quota")
def quota_group():
    """Manage per-project quotas (docs/scheduling.md)."""


@quota_group.command("ls")
def quota_ls():
    """List project quotas with live usage."""
    plane = get_plane()
    stats = plane.scheduling_stats()
    click.echo(f"{'PROJECT':16s} {'MAXRUNS':>7s} {'MAXCHIPS':>8s} "
               f"{'WEIGHT':>6s} {'RUNS':>4s} {'CHIPS':>5s} {'QUEUED':>6s}")
    for quota in stats["quotas"]:
        click.echo(
            f"{quota['project']:16s} "
            f"{('-' if quota['max_runs'] is None else str(quota['max_runs'])):>7s} "
            f"{('-' if quota['max_chips'] is None else str(quota['max_chips'])):>8s} "
            f"{quota['weight']:>6.2f} {quota['used_runs']:>4d} "
            f"{quota['used_chips']:>5d} {quota['queued']:>6d}")


@quota_group.command("set")
@click.argument("project")
@click.option("--max-runs", default=None, type=int,
              help="max concurrent runs for the project")
@click.option("--max-chips", default=None, type=int,
              help="max concurrent chips (cards) for the project")
@click.option("--weight", default=1.0, help="fair-share weight")
def quota_set(project, max_runs, max_chips, weight):
    plane = get_plane()
    quota = plane.set_quota(project, max_runs=max_runs, max_chips=max_chips,
                            weight=weight)
    click.echo(json.dumps(quota, indent=2, default=str))


@quota_group.command("rm")
@click.argument("project")
def quota_rm(project):
    plane = get_plane()
    if not plane.delete_quota(project):
        raise click.ClickException(f"no quota for project `{project}`")
    click.echo(f"Quota for `{project}` removed")


# -------------------------------------------------------------------- check
@cli.command()
@click.option("-f", "--polyaxonfile", "files", multiple=True, required=True,
              type=click.Path())
@click.option("-P", "--param", "params", multiple=True)
def check(files, params):
    """Validate a Polyaxonfile and print the resolved operation."""
    from polyaxon_tpu_torch.polyaxonfile import PolyaxonfileError, check_polyaxonfile

    try:
        op = check_polyaxonfile(list(files), params=_parse_params(params))
    except (PolyaxonfileError, ValueError) as exc:
        raise click.ClickException(str(exc)) from exc
    click.echo(json.dumps(op.to_dict(), indent=2, default=str))


def _parse_slices(entries) -> list[tuple[str, str, bool]]:
    """NAME:TOPOLOGY[:spot] → (name, topology, preemptible) triples."""
    parsed = []
    for entry in entries:
        parts = entry.split(":")
        if len(parts) not in (2, 3):
            raise click.ClickException(
                f"--slice must be NAME:TOPOLOGY[:spot], got {entry!r}")
        if len(parts) == 3 and parts[2] != "spot":
            raise click.ClickException(
                f"--slice third token must be `spot`, got {parts[2]!r}")
        parsed.append((parts[0], parts[1], len(parts) == 3))
    return parsed


# -------------------------------------------------------------------- admin
@cli.group("admin")
def admin_group():
    """Deploy/manage the control-plane stack (upstream `admin deploy`)."""


@admin_group.command("deploy")
@click.option("-f", "--file", "config_file", required=True, type=click.Path(exists=True))
@click.option("--dry-run", is_flag=True, help="validate and show the plan only")
def admin_deploy(config_file, dry_run):
    import yaml

    from polyaxon_tpu_torch.deploy import check_deployment, render_deployment

    with open(config_file) as fh:
        data = yaml.safe_load(fh)
    try:
        config = check_deployment(data or {})
    except ValueError as exc:
        raise click.ClickException(str(exc)) from exc
    home = config.home or get_home()
    if dry_run:
        click.echo(json.dumps({"valid": True,
                               "deploymentType": config.deployment_type,
                               "home": home}, indent=2))
        return
    written = render_deployment(config, home)
    click.echo(json.dumps(written, indent=2))


@admin_group.command("teardown")
@click.option("-f", "--file", "config_file", default=None,
              type=click.Path(exists=True),
              help="deploy values file (to locate a custom home:)")
def admin_teardown(config_file):
    import shutil

    home = get_home()
    if config_file:
        import yaml

        with open(config_file) as fh:
            data = yaml.safe_load(fh) or {}
        home = data.get("home") or home
    deploy_dir = os.path.join(home, "deploy")
    if not os.path.isdir(deploy_dir):
        click.echo("nothing deployed")
        return
    # Remove every artifact deploy recorded — including ones rendered
    # outside deploy/ (connections.yaml feeds the live catalog).
    summary_path = os.path.join(deploy_dir, "deploy.json")
    removed = []
    if os.path.exists(summary_path):
        try:
            with open(summary_path) as fh:
                artifacts = json.load(fh).get("artifacts") or {}
            for path in artifacts.values():
                if os.path.isfile(path) and not path.startswith(deploy_dir):
                    os.remove(path)
                    removed.append(path)
        except (OSError, json.JSONDecodeError):
            pass
    shutil.rmtree(deploy_dir)
    removed.append(deploy_dir)
    click.echo(json.dumps({"removed": removed}))


# ------------------------------------------------------------------- server
@cli.command("server")
@click.option("--host", default="127.0.0.1")
@click.option("--port", default=8000)
@click.option("--with-agent", is_flag=True,
              help="also run the agent reconcile loop in this process")
@click.option("--max-concurrent", default=4,
              help="(with --with-agent) max concurrent gangs")
@click.option("--heartbeat-timeout", default=60.0,
              help="(with --with-agent) slice-pool heartbeat timeout seconds")
@click.option("--slice", "slices", multiple=True,
              help="(with --with-agent) register a slice NAME:TOPOLOGY[:spot]; "
                   "a GPU host's N cards are NAME:N")
@click.option("--auth-token", default=None, envvar="POLYAXON_TPU_AUTH_TOKEN",
              help="admin bearer token; enables auth (default: open server)")
@click.option("--owner-token", "owner_tokens", multiple=True,
              help="OWNER=TOKEN per-owner scoped credential (repeatable); "
                   "implies auth")
@click.option("--chaos-plan", default=None,
              help="(with --with-agent) JSON fault plan injected at the "
                   "store/gang/checkpoint/tick seams (docs/robustness.md)")
@click.option("--device", default=None,
              help="(with --with-agent) " + _DEVICE_HELP)
def server_cmd(host, port, with_agent, max_concurrent, heartbeat_timeout,
               slices, auth_token, owner_tokens, chaos_plan, device):
    """Serve the REST API (control plane + streams) in the foreground."""
    import threading

    from polyaxon_tpu_torch.api import ApiServer

    if chaos_plan:
        from polyaxon_tpu_torch import chaos

        chaos.install(chaos.ChaosPlan.load(chaos_plan))
        click.echo(f"chaos plan armed from {chaos_plan}")
    scoped = {}
    for item in owner_tokens:
        owner, sep, token = item.partition("=")
        if not sep or not owner or not token:
            raise click.BadParameter(
                f"--owner-token needs OWNER=TOKEN, got {item!r}")
        scoped[owner] = token
    plane = get_plane()
    manager = None
    if with_agent and slices:
        from polyaxon_tpu_torch.agent import SliceManager

        manager = SliceManager(_parse_slices(slices),
                               heartbeat_timeout=heartbeat_timeout)
    server = ApiServer(plane, host, port, slice_manager=manager,
                       auth_token=auth_token, owner_tokens=scoped)
    if with_agent:
        from polyaxon_tpu_torch.agent import Agent

        agent = Agent(plane, slice_manager=manager,
                      max_concurrent=max_concurrent, device=device)
        # Foreground CLI: the agent lives exactly as long as the
        # blocking serve_forever below; process exit is the teardown.
        threading.Thread(target=agent.serve_forever, daemon=True).start()
    click.echo(f"API serving on {server.url} (home={get_home()})"
               + (" with agent" if with_agent else ""))
    try:
        server.httpd.serve_forever()
    finally:
        server.stop()


# -------------------------------------------------------------------- serve
@cli.command("serve")
@click.option("--model", required=True, help="model zoo name, e.g. llama3_8b")
@click.option("--checkpoint", default=None,
              help="the port's checkpoint dir (a saved train state, or "
                   "what `convert --from-hf` wrote)")
@click.option("--host", default="127.0.0.1")
@click.option("--port", default=8080)
@click.option("--seed", default=0)
@click.option("--batching", default="static",
              type=click.Choice(["static", "continuous"]),
              help="continuous = slot-pool batcher: concurrent requests "
                   "interleave token-by-token (decoder models)")
@click.option("--slots", default=4,
              help="KV-cache slots for --batching continuous")
@click.option("--mesh", "mesh_str", default=None,
              help="shard weights over a gang of processes, one card "
                   "each, e.g. 'tp=4' or 'fsdp=-1' (-1 = every process); "
                   "each process is started alike with the bootstrap's "
                   "env contract, rank 0 binds the port")
@click.option("--quantize", default=None, type=click.Choice(["int8"]),
              help="weight-only quantization at load: int8 + per-channel "
                   "scales (halves the resident weight bytes; decode is "
                   "bandwidth-bound)")
@click.option("--kv", default="dense", type=click.Choice(["dense", "paged"]),
              help="KV-cache layout for --batching continuous: paged = "
                   "vLLM-style shared page pool with per-slot block "
                   "tables (memory scales with held tokens, not "
                   "slots x max_len)")
@click.option("--kv-page-size", default=16,
              help="tokens per KV page (--kv paged)")
@click.option("--kv-pages", default=None, type=int,
              help="usable KV pages in the pool (--kv paged; matches "
                   "kv_pages_total in /v1/stats); default = the dense-"
                   "equivalent reservation, lower = deliberate "
                   "oversubscription with admission backpressure")
@click.option("--draft-model", default=None,
              help="speculative decoding draft (static engine, greedy "
                   "requests): lossless — output is the target's own "
                   "greedy sequence, the draft buys back decode steps")
@click.option("--draft-checkpoint", default=None,
              help="the port's checkpoint dir for the draft model")
@click.option("--spec-k", default=4,
              help="draft tokens proposed per verify round")
@click.option("--lora-alpha", default=16.0,
              help="alpha used when --checkpoint is a LoRA fine-tune "
                   "(adapters fold into dense weights at load; must "
                   "match training)")
@click.option("--max-pending", default=None, type=int,
              help="(--batching continuous) cap on queued requests; a "
                   "saturated POST /v1/generate answers 503 with "
                   "Retry-After instead of queueing unbounded work")
@click.option("--device", default=None, help=_DEVICE_HELP)
def serve_cmd(model, checkpoint, host, port, seed, batching, slots, mesh_str,
              quantize, kv, kv_page_size, kv_pages, draft_model,
              draft_checkpoint, spec_k, lora_alpha, max_pending, device):
    """Serve a model for generation (KV-cache decode over HTTP). SIGINT
    and SIGTERM stop the server and exit with 0; its last line is then
    its kernel launches, as JSON."""
    import signal
    import threading

    from polyaxon_tpu_torch.runtime.launch import emit_launches
    from polyaxon_tpu_torch.serving.server import ServingServer

    mesh_axes = None
    if mesh_str:
        from polyaxon_tpu_torch.parallel import parse_mesh_axes

        try:
            mesh_axes = parse_mesh_axes(mesh_str)
        except ValueError as exc:
            raise click.BadParameter(str(exc)) from None
    server = ServingServer(model, checkpoint, host=host, port=port, seed=seed,
                           batching=batching, slots=slots,
                           mesh_axes=mesh_axes, quantize=quantize,
                           kv=kv, page_size=kv_page_size, kv_pages=kv_pages,
                           draft_model=draft_model,
                           draft_checkpoint=draft_checkpoint, spec_k=spec_k,
                           lora_alpha=lora_alpha, max_pending=max_pending,
                           device=device)
    if not server.is_leader:
        server.follow()  # a sharded gang's rank > 0, until rank 0 stops
        return
    # Installed explicitly: a shell starts a background job with SIGINT
    # ignored, and Python then never raises KeyboardInterrupt.
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    click.echo(f"serving {model} at {server.url}")
    try:
        while not stop.wait(1.0):
            pass
    finally:
        # One teardown path: ServingServer.stop() owns the shutdown
        # sequence (httpd + engine).
        server.stop()
        emit_launches()


# ------------------------------------------------------------------ convert
@cli.command("convert")
@click.option("--model", required=True,
              help="target model zoo name, e.g. llama3_8b")
@click.option("--from-hf", "hf_path", default=None,
              help="import: HF checkpoint (.safetensors/.bin file or a "
                   "model dir) → the port's checkpoint store at --out "
                   "(what `serve --checkpoint` reads)")
@click.option("--from-orbax", "orbax_path", default=None,
              help="export: the port's checkpoint dir (a train state, "
                   "incl. LoRA fine-tunes — adapters merge) → HF "
                   "safetensors + config.json at --out. The name is "
                   "kept for scripts written for plx; a real Orbax "
                   "directory of the JAX package is converted to the "
                   "port's store by scripts/convert_orbax_to_torch.py "
                   "first")
@click.option("--out", "out_dir", required=True,
              help="output dir (the port's store when importing, HF when "
                   "exporting)")
def convert_cmd(model, hf_path, orbax_path, out_dir):
    """Convert between HuggingFace llama checkpoints and the port's
    checkpoint store, either direction (models/convert.py::from_hf_llama
    / to_hf_llama)."""
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.models.convert import from_hf_llama
    from polyaxon_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                       CheckpointSpec,
                                                       flatten)

    if (hf_path is None) == (orbax_path is None):
        raise click.UsageError(
            "pass exactly one of --from-hf (import) or --from-orbax "
            "(export)")
    if model not in llama.CONFIGS:
        raise click.BadParameter(
            f"`{model}` is not a llama-family model "
            f"(choices: {sorted(llama.CONFIGS)})")
    cfg = llama.CONFIGS[model]

    if orbax_path is not None:
        return _export_to_hf(model, cfg, orbax_path, out_dir)

    def load_state_dict(path):
        if os.path.isdir(path):
            names = sorted(os.listdir(path))
            # Prefer safetensors; otherwise HF weight shards only —
            # Trainer dirs also hold non-weight pickles like
            # training_args.bin that torch.load(weights_only) rejects.
            files = [os.path.join(path, f) for f in names
                     if f.endswith(".safetensors")]
            if not files:
                files = [os.path.join(path, f) for f in names
                         if f.startswith("pytorch_model")
                         and f.endswith(".bin")]
            if not files:
                raise click.ClickException(
                    f"no *.safetensors or pytorch_model*.bin under {path}")
        else:
            files = [path]
        state = {}
        for f in files:
            if f.endswith(".safetensors"):
                # The torch loader: numpy has no bf16, the dtype HF
                # checkpoints usually ship.
                from safetensors.torch import load_file

                state.update(load_file(f))
            else:
                import torch

                state.update(torch.load(f, map_location="cpu",
                                        weights_only=True))
        return state

    ckpt = CheckpointManager(out_dir, CheckpointSpec(
        enabled=True, interval_steps=1, async_save=False))
    try:
        if ckpt.latest_step() is not None:
            raise click.ClickException(
                f"{out_dir} already contains a checkpoint "
                f"(step {ckpt.latest_step()}); choose a new --out or "
                "delete it first")
        state_dict = load_state_dict(hf_path)
        try:
            variables = from_hf_llama(state_dict, cfg)
        except (KeyError, ValueError) as exc:
            raise click.ClickException(
                f"checkpoint does not match model `{model}`: {exc}"
            ) from exc
        del state_dict
        ckpt.save(0, {"params": variables["params"]}, force=True)
    finally:
        ckpt.close()
    n_params = sum(int(p.numel()) for _, p in flatten(variables["params"]))
    click.echo(f"converted {model}: {n_params:,} params → {out_dir}")


def _export_to_hf(model: str, cfg, ckpt_path: str, out_dir: str) -> None:
    """The port's train state (plain or LoRA) → HF-loadable dir:
    model.safetensors + config.json."""
    import json as _json

    from safetensors.numpy import save_file

    from polyaxon_tpu_torch.models.convert import to_hf_llama
    from polyaxon_tpu_torch.runtime.checkpoint import load_tree

    if cfg.sliding_window is not None:
        raise click.ClickException(
            f"`{model}` uses sliding-window attention, which HF's llama "
            "architecture does not express — an export would silently "
            "attend past the window; not supported")
    if os.path.exists(os.path.join(out_dir, "model.safetensors")):
        raise click.ClickException(
            f"{out_dir} already contains model.safetensors; choose a new "
            "--out or delete it first")
    try:
        step, restored = load_tree(ckpt_path, only="params")
    except FileNotFoundError:
        raise click.ClickException(f"no checkpoint under {ckpt_path}")
    params = restored.get("params", restored)
    if isinstance(params, dict) and set(params) == {"base", "lora"}:
        from polyaxon_tpu_torch.models.lora import merge_saved

        params = merge_saved(params["base"], params["lora"], device="cpu")
        click.echo("merged LoRA adapters into dense weights")
    state_dict = to_hf_llama(params, cfg)
    os.makedirs(out_dir, exist_ok=True)
    # metadata format=pt: transformers' loader checks it before
    # trusting the file.
    save_file(state_dict, os.path.join(out_dir, "model.safetensors"),
              metadata={"format": "pt"})
    config = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.dim,
        "intermediate_size": cfg.ffn_dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": "float32",
    }
    if cfg.rope_scaling is not None:
        # Ours carries the public llama3 rule's fields; HF wants the
        # same dict plus its rope_type tag. Dropping this would export
        # llama31_* with silently unscaled RoPE.
        config["rope_scaling"] = {"rope_type": "llama3",
                                  **dict(cfg.rope_scaling)}
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        _json.dump(config, fh, indent=2)
    n_params = sum(int(v.size) for v in state_dict.values())
    click.echo(f"exported {model} step {step}: {n_params:,} params → "
               f"{out_dir} (model.safetensors + config.json)")


# -------------------------------------------------------------------- agent
@cli.command("agent")
@click.option("--poll", default=1.0)
@click.option("--max-concurrent", default=4)
@click.option("--slice", "slices", multiple=True,
              help="Register a slice: NAME:TOPOLOGY[:spot], e.g. "
                   "gpu0:4 (a GPU host's four cards) or spot0:2:spot. "
                   "Enables the native topology-aware gang scheduler.")
@click.option("--chaos-plan", default=None,
              help="JSON fault plan (file or inline) injected at the "
                   "store/gang/checkpoint/tick seams — resilience "
                   "drills against a live agent (docs/robustness.md)")
@click.option("--device", default=None, help=_DEVICE_HELP)
def agent_cmd(poll, max_concurrent, slices, chaos_plan, device):
    """Run the agent reconcile loop in the foreground."""
    from polyaxon_tpu_torch.agent import Agent

    if chaos_plan:
        from polyaxon_tpu_torch import chaos

        chaos.install(chaos.ChaosPlan.load(chaos_plan))
        click.echo(f"chaos plan armed from {chaos_plan}")
    manager = None
    if slices:
        from polyaxon_tpu_torch.agent import SliceManager

        manager = SliceManager(_parse_slices(slices))
    plane = get_plane()
    agent = Agent(plane, max_concurrent=max_concurrent, slice_manager=manager,
                  device=device)
    click.echo(f"Agent serving (home={get_home()}"
               + (f", slices={[s for s in slices]}" if slices else "") + ")")
    agent.serve_forever(poll_seconds=poll)


# ------------------------------------------------------------------- models
@cli.command("version")
def version_cmd():
    """Print client/library version."""
    from polyaxon_tpu_torch import __version__

    click.echo(json.dumps({"version": __version__}))


@cli.command("models")
def models_cmd():
    """List builtin model zoo entries."""
    from polyaxon_tpu_torch.models import available_models

    for name in available_models():
        click.echo(name)


if __name__ == "__main__":
    cli()
