"""The embedded control plane: run CRUD + lifecycle + compilation.

haupt's API layer collapsed into an in-process service (SURVEY.md §2
"API server", §7 step 4): same capability set — submit, compile, stop,
approve, restart/resume, statuses, metrics — without Django or a
network hop. An HTTP facade can wrap this class 1:1 later; the CLI and
tuner consume it directly.

Port of ``polyaxon_tpu/controlplane/service.py``, the same code under
the port's module names.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Union

from polyaxon_tpu_torch.compiler import compile_operation
from polyaxon_tpu_torch.controlplane.store import RunRecord, Store
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.polyaxonfile import (
    check_polyaxonfile,
    get_operation,
    resolve_operation_context,
)
from polyaxon_tpu_torch.polyflow.operation import V1Operation
from polyaxon_tpu_torch.polyflow.runs import V1RunKind
from polyaxon_tpu_torch.streams import StreamsService


class ControlPlane:
    def __init__(self, home: str):
        self.home = os.path.abspath(home)
        os.makedirs(self.home, exist_ok=True)
        self.store = Store(os.path.join(self.home, "plx.db"))
        self.artifacts_root = os.path.join(self.home, "artifacts")
        os.makedirs(self.artifacts_root, exist_ok=True)
        self.streams = StreamsService(self.artifacts_root)
        from polyaxon_tpu_torch.connections import ConnectionCatalog

        self.connections = ConnectionCatalog(home=self.home)
        # The implicit default queue always exists so bare submits (no
        # `queue:` in the spec) validate and list like any other queue.
        from polyaxon_tpu_torch.scheduling import DEFAULT_QUEUE

        if self.store.get_queue(DEFAULT_QUEUE) is None:
            self.store.upsert_queue(
                DEFAULT_QUEUE, priority=0,
                description="implicit default queue")

    # -- submission --------------------------------------------------------
    def submit(
        self,
        polyaxonfile: Union[str, dict, Sequence, None] = None,
        *,
        op: Optional[V1Operation] = None,
        project: str = "default",
        params: Optional[dict[str, Any]] = None,
        presets: Optional[Sequence[Union[str, dict]]] = None,
        name: Optional[str] = None,
        tags: Optional[list[str]] = None,
        meta: Optional[dict] = None,
        parent_uuid: Optional[str] = None,
        pipeline_uuid: Optional[str] = None,
        iteration: Optional[int] = None,
    ) -> RunRecord:
        if op is None:
            op = check_polyaxonfile(polyaxonfile, params=params, presets=presets)
        elif params or presets:
            op = check_polyaxonfile(op.to_dict(), params=params, presets=presets)
        is_pipeline = op.matrix is not None or (
            op.component is not None and op.component.run_kind == V1RunKind.DAG
        )
        if op.schedule is not None:
            kind = "schedule"  # a recurring parent that spawns child runs
            cron_expr = getattr(op.schedule, "cron", None)
            if cron_expr:
                from polyaxon_tpu_torch.controlplane.cron import Cron

                Cron(cron_expr)  # fail fast at submit, not in the agent
        elif op.matrix is not None:
            kind = "matrix"
        elif is_pipeline:
            kind = V1RunKind.DAG
        else:
            kind = op.component.run_kind if op.component else "hub"
        if parent_uuid and not (meta or {}).get("owner"):
            # Child runs (matrix trials, DAG nodes, schedule fires)
            # inherit the submitting owner's stamp: API-level isolation
            # keys off meta["owner"], and a sweep's trials must stay
            # visible to the owner who submitted the sweep.
            parent_owner = (self.store.get_run(parent_uuid).meta
                            or {}).get("owner")
            if parent_owner:
                meta = {**(meta or {}), "owner": parent_owner}
        # Project row + run row land in one commit: a crash between
        # them would leave a project with no run (or, ordered the other
        # way, a run pointing at a missing project).
        with self.store.transaction():
            self.store.create_project(project)
            record = self.store.create_run(
                project=project,
                spec=op.to_dict(),
                name=name or op.name or (op.component.name if op.component else None),
                kind=kind,
                params={k: p.to_dict() for k, p in (op.params or {}).items()} or None,
                tags=tags or op.tags,
                meta=meta,
                parent_uuid=parent_uuid,
                pipeline_uuid=pipeline_uuid,
                iteration=iteration,
            )
        return record

    # -- compilation -------------------------------------------------------
    def resolve_hub_ref(self, ref: str):
        """Load a component from the local hub (<home>/hub/<name>.yaml).

        Upstream resolves hub refs against the component registry; the
        embedded plane's registry is a directory of component files.
        Version tags (``name:tag``) select ``<name>-<tag>.yaml`` first,
        then fall back to ``<name>.yaml``.
        """
        from polyaxon_tpu_torch.polyaxonfile import get_component, load_specs

        name, _, tag = ref.partition(":")
        hub_dir = os.path.join(self.home, "hub")
        candidates = [f"{name}-{tag}" if tag else None, name]
        for candidate in candidates:
            if not candidate:
                continue
            for ext in (".yaml", ".yml", ".json"):
                path = os.path.join(hub_dir, candidate + ext)
                if os.path.exists(path):
                    return get_component(load_specs(path))
        raise ValueError(
            f"hub component `{ref}` not found under {hub_dir}")

    def compile_run(self, run_uuid: str) -> RunRecord:
        """created → compiled → queued (SURVEY §3.1 lifecycle tail).

        The whole resolution+compilation is one ``compile`` span on the
        run's lifecycle timeline (obs.trace): trace_id = run uuid, and
        a failed compile records an error span before the scheduler
        pins the FAILED condition.
        """
        import time as _time

        from polyaxon_tpu_torch.obs import trace as obs_trace

        t0 = _time.time()
        try:
            record = self._compile_run(run_uuid)
        except Exception as exc:
            obs_trace.record_completed(
                self.run_artifacts_dir(run_uuid), run_uuid, "compile",
                start=t0, end=_time.time(), component="controlplane",
                status="error", error=f"{type(exc).__name__}: {exc}")
            raise
        obs_trace.record_completed(
            self.run_artifacts_dir(run_uuid), run_uuid, "compile",
            start=t0, end=_time.time(), component="controlplane",
            attributes={"kind": record.kind, "status": record.status.value,
                        "queue": ((record.meta or {}).get("scheduling")
                                  or {}).get("queue")})
        return record

    def _compile_run(self, run_uuid: str) -> RunRecord:
        record = self.store.get_run(run_uuid)
        op = get_operation(record.spec)
        if op.component is None and op.hub_ref:
            component = self.resolve_hub_ref(op.hub_ref)
            # exactly-one-source validation: swap hubRef → component via
            # a dict rebuild (validate_assignment rejects in-place edits).
            op_dict = op.to_dict()
            op_dict.pop("hubRef", None)
            op_dict["component"] = component.to_dict()
            op = get_operation(op_dict)
            # The resolved component may be a pipeline: recompute kind so
            # a hub DAG takes the pipeline path, not the job compiler.
            kind = component.run_kind or record.kind
            self.store.update_run(run_uuid, spec=op.to_dict(), kind=kind)
            record = self.store.get_run(run_uuid)
        if record.kind in ("matrix", V1RunKind.DAG, "schedule"):
            # Pipelines compile trivially: children are compiled per-trial.
            self.store.transition(run_uuid, V1Statuses.COMPILED, reason="PipelineCompiled")
            self.store.transition(run_uuid, V1Statuses.QUEUED)
            return self.store.get_run(run_uuid)
        trial_params = dict((record.meta or {}).get("trial_params") or {})
        if op.joins:
            from polyaxon_tpu_torch.controlplane.joins import resolve_joins

            matched: list[str] = []
            joined = resolve_joins(
                self.store, self.streams,
                [j.to_dict() for j in op.joins], project=record.project,
                matched=matched)
            trial_params.update(joined)
            if matched:
                # Join upstreams are lineage edges (inputs → this run);
                # stamped here because the query result is not
                # re-derivable after the upstream set changes.
                meta = dict(record.meta or {})
                meta["upstream_runs"] = sorted(set(matched))
                self.store.update_run(run_uuid, meta=meta)
                record = self.store.get_run(run_uuid)
        resolved = resolve_operation_context(
            op,
            params=trial_params,
            run_uuid=record.uuid,
            run_name=record.name or "",
            project_name=record.project,
            iteration=record.iteration,
            artifacts_root=self.artifacts_root,
        )
        plan = compile_operation(
            resolved,
            run_uuid=record.uuid,
            artifacts_root=self.artifacts_root,
            project=record.project,
            catalog=self.connections,
            hub_resolver=self.resolve_hub_ref,
        )
        self.store.update_run(
            run_uuid, resolved_spec=resolved.to_dict(), launch_plan=plan.to_dict()
        )
        self._stamp_scheduling(run_uuid, resolved, plan)

        # Run memoization (upstream V1Cache lifecycle: created →
        # awaiting_cache → succeeded on hit / compiled on miss): an
        # identical resolved component+params that already succeeded
        # short-circuits and reuses the hit's outputs.
        cache = op.cache
        if cache is not None and not cache.disable:
            key = self._cache_key(resolved)
            self.store.transition(run_uuid, V1Statuses.AWAITING_CACHE)
            hit = self.store.find_cached(key, project=record.project, ttl=cache.ttl)
            if hit is not None and hit.uuid != run_uuid:
                self._adopt_outputs(hit, run_uuid)
                meta = dict(record.meta or {})
                meta["cache_hit_from"] = hit.uuid
                self.store.update_run(run_uuid, meta=meta, cache_key=key)
                self._index_lineage(run_uuid)
                self.store.transition(
                    run_uuid, V1Statuses.SUCCEEDED, reason="CacheHit",
                    message=f"reused outputs of {hit.uuid}")
                return self.store.get_run(run_uuid)
            self.store.update_run(run_uuid, cache_key=key)

        self._index_lineage(run_uuid)
        self.store.transition(run_uuid, V1Statuses.COMPILED, reason="Compiled")
        self.store.transition(run_uuid, V1Statuses.QUEUED)
        return self.store.get_run(run_uuid)

    def _stamp_scheduling(self, run_uuid: str, resolved: V1Operation,
                          plan) -> None:
        """Resolve queue + priority class against the catalog and stamp
        ``meta["scheduling"]`` so admission ticks never re-parse specs.

        Unknown queue/priority-class names raise ``SchedulingError``
        here — at compile, where the submitting user sees the failure —
        instead of silently landing at the back of the default queue.
        """
        from polyaxon_tpu_torch.scheduling import (
            DEFAULT_QUEUE,
            RunSchedInfo,
            SchedulingError,
            resolve_priority_class,
        )

        queue_name = plan.queue or DEFAULT_QUEUE
        if self.store.get_queue(queue_name) is None:
            known = [q["name"] for q in self.store.list_queues()]
            raise SchedulingError(
                f"unknown queue `{queue_name}` (known: {known}); create it "
                "with `plx queue add`")
        run = resolved.component.run if resolved.component else None
        env = getattr(run, "environment", None)
        class_name = getattr(env, "priority_class_name", None) or None
        priority = resolve_priority_class(class_name)  # raises on unknown
        resources = plan.resources
        info = RunSchedInfo(
            queue=queue_name,
            priority_class=(str(class_name).lower() if class_name
                            else "default"),
            priority=priority,
            chips=int(getattr(resources, "chips", 0) or 0),
            preemptible=bool(getattr(resources, "preemptible", False)),
        )
        record = self.store.get_run(run_uuid)
        meta = dict(record.meta or {})
        meta["scheduling"] = info.to_meta()
        self.store.update_run(run_uuid, meta=meta)

    # -- scheduling catalog ------------------------------------------------
    def upsert_queue(self, name: str, **kwargs) -> dict:
        return self.store.upsert_queue(name, **kwargs)

    def delete_queue(self, name: str) -> bool:
        from polyaxon_tpu_torch.scheduling import DEFAULT_QUEUE

        if name == DEFAULT_QUEUE:
            raise ValueError("the default queue cannot be deleted")
        return self.store.delete_queue(name)

    def set_quota(self, project: str, **kwargs) -> dict:
        return self.store.set_quota(project, **kwargs)

    def delete_quota(self, project: str) -> bool:
        return self.store.delete_quota(project)

    def scheduling_stats(self) -> dict:
        """Queue depth + quota usage, the operator view surfaced by
        ``GET /api/v1/queues|quotas`` and ``plx queue ls``."""
        from polyaxon_tpu_torch.scheduling import LIVE_STATUSES, sched_info

        pipeline_kinds = {"matrix", V1RunKind.DAG, "schedule"}
        queued = [r for r in self.store.list_runs(statuses=[V1Statuses.QUEUED])
                  if r.kind not in pipeline_kinds]
        live = [r for r in self.store.list_runs(statuses=LIVE_STATUSES)
                if r.kind not in pipeline_kinds]
        depth: dict[str, int] = {}
        running: dict[str, int] = {}
        projects: dict[str, dict] = {}
        for record in queued:
            info = sched_info(record)
            depth[info.queue] = depth.get(info.queue, 0) + 1
            usage = projects.setdefault(
                record.project, {"runs": 0, "chips": 0, "queued": 0})
            usage["queued"] += 1
        for record in live:
            info = sched_info(record)
            running[info.queue] = running.get(info.queue, 0) + 1
            usage = projects.setdefault(
                record.project, {"runs": 0, "chips": 0, "queued": 0})
            usage["runs"] += 1
            usage["chips"] += info.chips
        queues = []
        for row in self.store.list_queues():
            queues.append({**row,
                           "depth": depth.get(row["name"], 0),
                           "running": running.get(row["name"], 0)})
        quotas = []
        for row in self.store.list_quotas():
            usage = projects.get(row["project"],
                                 {"runs": 0, "chips": 0, "queued": 0})
            quotas.append({**row, "used_runs": usage["runs"],
                           "used_chips": usage["chips"],
                           "queued": usage["queued"]})
        return {"queues": queues, "quotas": quotas, "projects": projects}

    @staticmethod
    def _cache_key(resolved: V1Operation) -> str:
        """Content hash of what determines a run's outputs: the resolved
        component spec + literal params."""
        import hashlib
        import json as _json

        payload = {
            "component": resolved.component.to_dict() if resolved.component else None,
            "params": {k: p.to_dict() for k, p in (resolved.params or {}).items()},
        }
        return hashlib.sha256(
            _json.dumps(payload, sort_keys=True, default=str).encode()
        ).hexdigest()

    def _adopt_outputs(self, hit: RunRecord, run_uuid: str) -> None:
        """Copy the cache hit's outputs manifest into the new run's dir."""
        import shutil

        src = os.path.join(self.artifacts_root, hit.uuid)
        dst = os.path.join(self.artifacts_root, run_uuid)
        os.makedirs(dst, exist_ok=True)
        for name in ("outputs.json",):
            path = os.path.join(src, name)
            if os.path.exists(path):
                shutil.copy2(path, os.path.join(dst, name))
        outputs_dir = os.path.join(src, "outputs")
        if os.path.isdir(outputs_dir):
            shutil.copytree(
                outputs_dir, os.path.join(dst, "outputs"), dirs_exist_ok=True)

    # -- lifecycle ops -----------------------------------------------------
    def stop(self, run_uuid: str, message: str = "") -> None:
        record = self.store.get_run(run_uuid)
        if record.is_done:
            return
        self.store.transition(run_uuid, V1Statuses.STOPPING, message=message)
        for child in self.store.list_runs(pipeline_uuid=run_uuid):
            if not child.is_done:
                self.stop(child.uuid, message="pipeline stopped")

    def restart(self, run_uuid: str, *, copy: bool = False) -> RunRecord:
        record = self.store.get_run(run_uuid)
        meta = dict(record.meta or {})
        meta["restarted_from"] = record.uuid
        if copy:
            meta["copy_artifacts_from"] = record.uuid
        return self.store.create_run(
            project=record.project,
            spec=record.spec,
            name=record.name,
            kind=record.kind,
            params=record.params,
            tags=record.tags,
            meta=meta,
            parent_uuid=record.parent_uuid,
        )

    def resume(self, run_uuid: str) -> RunRecord:
        """Requeue a stopped/failed/preempted run in place, keeping its
        artifacts dir so checkpoint restore continues from the last step
        (SURVEY §5.4: the build owns both halves of resume)."""
        record = self.store.get_run(run_uuid)
        if not record.is_done and record.status != V1Statuses.PREEMPTED:
            raise ValueError(f"Run `{run_uuid}` is not resumable from {record.status}")
        if record.launch_plan:
            # One commit for the whole requeue hop: a crash mid-chain
            # would otherwise strand the run in RESUMING/COMPILED where
            # neither the scheduler nor resume() would pick it back up.
            with self.store.transaction():
                self.store.transition(run_uuid, V1Statuses.RESUMING, force=True)
                self.store.transition(run_uuid, V1Statuses.COMPILED)
                self.store.transition(run_uuid, V1Statuses.QUEUED)
            return self.store.get_run(run_uuid)
        self.store.transition(run_uuid, V1Statuses.RESUMING, force=True)
        # Stopped before compilation: compile now (resolves + queues).
        return self.compile_run(run_uuid)

    # -- reads -------------------------------------------------------------
    def get_run(self, run_uuid: str) -> RunRecord:
        return self.store.get_run(run_uuid)

    def list_runs(self, **kwargs) -> list[RunRecord]:
        return self.store.list_runs(**kwargs)

    def get_statuses(self, run_uuid: str) -> list[dict]:
        return self.store.get_conditions(run_uuid)

    def get_metric(self, run_uuid: str, name: str) -> Optional[float]:
        value = self.streams.last_metric(run_uuid, name)
        if value is None:
            outputs = self.streams.get_outputs(run_uuid)
            for key in (name, f"final_{name}"):
                if key in outputs:
                    return float(outputs[key])
        return value

    def run_artifacts_dir(self, run_uuid: str) -> str:
        return os.path.join(self.artifacts_root, run_uuid)

    def timeline(self, run_uuid: str) -> dict:
        """The run's ordered lifecycle span tree (obs.trace):
        compile → admission → placement → execute(init) →
        runtime(jit_compile/step/checkpoint/...) → sync, with chaos and
        retry annotations attached to the phase they hit. Backs
        ``GET .../runs/<uuid>/timeline`` and ``plx ops timeline``."""
        from polyaxon_tpu_torch.obs.trace import build_timeline, read_trace

        self.store.get_run(run_uuid)  # 404s unknown uuids at the API edge
        return build_timeline(read_trace(self.run_artifacts_dir(run_uuid)),
                              trace_id=run_uuid)

    def report(self, run_uuid: str) -> dict:
        """Performance attribution report (obs.analyze): the run's wall
        clock decomposed into phases, step-time trend with anomaly
        flags, and retry/chaos/requeue annotations per phase — plus the
        run's status and any alerts that fired on it."""
        from polyaxon_tpu_torch.obs.analyze import analyze_timeline

        record = self.store.get_run(run_uuid)
        report = analyze_timeline(self.timeline(run_uuid))
        report["status"] = record.status.value
        report["retries"] = record.retries
        report["alerts"] = (record.meta or {}).get("alerts") or []
        return report

    def verify(self, run_uuid: Optional[str] = None) -> dict:
        """Telemetry-oracle verdicts (obs.oracle): the committed
        invariant set judged against this plane's end state —
        scoped to one run when ``run_uuid`` is given, fleet-wide
        otherwise."""
        from polyaxon_tpu_torch.obs.oracle import verify_plane

        if run_uuid is not None:
            self.store.get_run(run_uuid)  # raises for an unknown uuid
        return verify_plane(self, run_uuid=run_uuid)

    # -- cross-run lineage -------------------------------------------------
    def _upstream_edges(
        self, record: RunRecord,
        sibling_cache: Optional[dict] = None,
    ) -> list[tuple[str, str, Optional[str]]]:
        """(upstream_uuid, edge_kind, label) for every input edge the
        data model records: ``runs.<uuid>``/``ops.<name>`` param refs,
        DAG dependencies, join matches (meta.upstream_runs, stamped at
        compile), and cache adoption. ``sibling_cache`` (pipeline_uuid
        → {name: record}) is shared by the project-wide downstream scan
        so sibling listings run once per pipeline, not once per run."""
        out: list[tuple[str, str, Optional[str]]] = []
        cache = sibling_cache if sibling_cache is not None else {}

        def sibs() -> dict[str, RunRecord]:
            key = record.pipeline_uuid
            if not key:
                return {}
            if key not in cache:
                cache[key] = {c.name: c for c in self.store.list_runs(
                    pipeline_uuid=key)}
            return cache[key]

        # Param refs + DAG dependencies need only the raw spec dict —
        # no pydantic re-validation per scanned run.
        for name, param in (record.params or {}).items():
            ref = param.get("ref") if isinstance(param, dict) else None
            if not ref:
                continue
            if ref.startswith("runs."):
                out.append((ref.split(".")[1], "param", name))
            elif ref.startswith("ops."):
                sib = sibs().get(ref.split(".")[1])
                if sib is not None:
                    out.append((sib.uuid, "param", name))
        meta = record.meta or {}
        for uuid in meta.get("upstream_runs") or []:
            out.append((uuid, "join", None))
        if meta.get("cache_hit_from"):
            out.append((meta["cache_hit_from"], "cache", None))
        deps = (record.spec or {}).get("dependencies") or []
        if deps and record.pipeline_uuid:
            for dep in deps:
                sib = sibs().get(dep)
                if sib is not None:
                    out.append((sib.uuid, "dag", None))
        return out

    def _index_lineage(self, run_uuid: str) -> None:
        """Mirror this run's upstream edges onto each upstream's
        ``meta["downstream_runs"]`` at compile time (ADVICE r5: the
        per-request ``lineage_graph`` downstream scan re-derived edges
        for every run in the project — O(runs) store reads per call).
        Every edge kind the data model records (param refs, DAG deps,
        joins, cache adoption) is known by the time a run leaves
        compile, so submit time is the one place the index stays
        consistent. ``meta["lineage_indexed"]`` marks the run so the
        request-time scan skips re-deriving it."""
        record = self.store.get_run(run_uuid)
        # The mirrored edges and the indexed marker are one unit: a
        # crash after some edge writes but before the marker would look
        # indexed-enough to skip yet miss edges, so batch the lot.
        with self.store.transaction():
            for uuid, kind, label in self._upstream_edges(record):
                try:
                    up = self.store.get_run(uuid)
                except KeyError:  # deleted upstream: no edge
                    continue
                meta = dict(up.meta or {})
                edges = list(meta.get("downstream_runs") or [])
                entry = {"uuid": run_uuid, "kind": kind,
                         **({"label": label} if label else {})}
                if entry not in edges:
                    edges.append(entry)
                    meta["downstream_runs"] = edges
                    self.store.update_run(uuid, meta=meta)
            meta = dict(record.meta or {})
            meta["lineage_indexed"] = True
            self.store.update_run(run_uuid, meta=meta)

    def lineage_graph(self, run_uuid: str) -> dict:
        """Inputs → run → outputs across runs (SURVEY §2 "Tracking":
        upstream's artifact-lineage graph view): upstream runs feeding
        this one (param refs, DAG deps, joins, cache adoption),
        downstream runs consuming it, and the run's own artifact
        records + outputs as the terminal nodes."""
        record = self.store.get_run(run_uuid)
        nodes: dict[str, dict] = {}
        edges: list[dict] = []

        def node(r: RunRecord) -> None:
            # "owner" rides along so the API's scoped-token filter can
            # drop foreign nodes without an extra get_run per node.
            nodes.setdefault(r.uuid, {
                "uuid": r.uuid, "name": r.name, "kind": r.kind,
                "status": r.status.value,
                "owner": (r.meta or {}).get("owner"),
            })

        node(record)
        sibling_cache: dict = {}
        for uuid, kind, label in self._upstream_edges(record, sibling_cache):
            try:
                up = self.store.get_run(uuid)
            except KeyError:  # deleted upstream: drop edge
                continue
            node(up)
            edges.append({"from": uuid, "to": run_uuid, "kind": kind,
                          **({"label": label} if label else {})})
        # Downstream edges come from the submit-time index (mirrored
        # into meta["downstream_runs"] by _index_lineage); the
        # re-deriving scan survives ONLY for legacy records compiled
        # before the index existed (meta.lineage_indexed unset), so a
        # hot-path request costs one list query + O(edges) lookups
        # instead of O(runs) edge derivations (ADVICE r5).
        seen_down: set[tuple] = set()
        for entry in (record.meta or {}).get("downstream_runs") or []:
            try:
                down = self.store.get_run(entry["uuid"])
            except KeyError:  # deleted downstream
                continue
            node(down)
            edge = {"from": run_uuid, "to": down.uuid,
                    "kind": entry.get("kind"),
                    **({"label": entry["label"]}
                       if entry.get("label") else {})}
            seen_down.add((down.uuid, edge["kind"], entry.get("label")))
            edges.append(edge)
        for other in self.store.list_runs(project=record.project):
            if other.uuid == run_uuid or (other.meta or {}).get(
                    "lineage_indexed"):
                continue
            for uuid, kind, label in self._upstream_edges(
                    other, sibling_cache):
                if uuid == run_uuid and (other.uuid, kind,
                                         label) not in seen_down:
                    node(other)
                    edges.append({
                        "from": run_uuid, "to": other.uuid, "kind": kind,
                        **({"label": label} if label else {})})
        return {
            "run": run_uuid,
            "nodes": list(nodes.values()),
            "edges": edges,
            "artifacts": self.streams.get_lineage(run_uuid),
            "outputs": self.streams.get_outputs(run_uuid),
        }
