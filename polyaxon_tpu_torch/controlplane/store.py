"""SQLite-backed run/project store — the reference's haupt DB collapsed
to an embedded, dependency-free layer (SURVEY.md §2 "API server" [K],
§7: "control plane + scheduler, single binary, SQLite").

WAL mode so the scheduler/agent threads and CLI reads interleave safely.

Hot-path design (ISSUE 8, sized by the fleet simulator in
the JAX package's ``polyaxon_tpu/sim``):

- ``RunRecord`` is a lazy row view: the JSON columns (``spec``,
  ``resolved_spec``, ``launch_plan``, ``params``, ``tags``, ``meta``)
  decode on first attribute access and cache. A 10k-deep queue scan
  that only reads ``uuid``/``status``/``kind`` never pays ~0.1 ms/row
  of deserialization.
- ``scan_runs`` folds the scheduler's per-tick status scans into ONE
  query (optionally kind-filtered per partition, so non-pipeline
  QUEUED/RUNNING rows are never even fetched); ``list_run_uuids`` is
  the key-only projection for terminal sweeps that diff against
  in-memory sets before touching any payload.
- ``transaction()`` batches every write inside the block into a single
  commit (one WAL fsync per tick instead of one per transition).
- ``add_transition_listener`` is the admission controller's delta feed:
  each status change is pushed to subscribers so the live view updates
  incrementally instead of being rebuilt O(live+queued) every pass.
- every connection is wrapped in a counting proxy: ``stats`` exposes
  per-store query/row counts (the sim budget gate and the query-count
  regression test read these) and each statement's latency lands in the
  ``polyaxon_runstore_op_seconds`` histogram.

Port of ``polyaxon_tpu/controlplane/store.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sqlite3
import threading
import time
import uuid as _uuid
from typing import Any, Callable, Optional, Sequence

from polyaxon_tpu_torch.lifecycle import V1Statuses, can_transition, now

logger = logging.getLogger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS projects (
    name TEXT PRIMARY KEY,
    description TEXT,
    created_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS runs (
    uuid TEXT PRIMARY KEY,
    project TEXT NOT NULL,
    name TEXT,
    description TEXT,
    kind TEXT,
    managed_by TEXT DEFAULT 'agent',
    status TEXT NOT NULL,
    spec TEXT,
    resolved_spec TEXT,
    launch_plan TEXT,
    params TEXT,
    tags TEXT,
    meta TEXT,
    parent_uuid TEXT,
    pipeline_uuid TEXT,
    iteration INTEGER,
    retries INTEGER DEFAULT 0,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    started_at TEXT,
    finished_at TEXT
);
CREATE INDEX IF NOT EXISTS idx_runs_status ON runs(status);
CREATE INDEX IF NOT EXISTS idx_runs_project ON runs(project);
CREATE INDEX IF NOT EXISTS idx_runs_pipeline ON runs(pipeline_uuid);
-- Composite index for the list_runs hot path: status equality then the
-- (created_at, rowid) order — rowid is the implicit last index column,
-- so the PR 2 same-second tie-break is served straight off the index
-- with no sort step (asserted by a query-plan test).
CREATE INDEX IF NOT EXISTS idx_runs_status_created
    ON runs(status, created_at);
CREATE TABLE IF NOT EXISTS conditions (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_uuid TEXT NOT NULL,
    type TEXT NOT NULL,
    reason TEXT,
    message TEXT,
    created_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_conditions_run ON conditions(run_uuid);
CREATE TABLE IF NOT EXISTS queues (
    name TEXT PRIMARY KEY,
    priority INTEGER NOT NULL DEFAULT 0,
    concurrency INTEGER,
    preemptible INTEGER NOT NULL DEFAULT 0,
    description TEXT,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS quotas (
    project TEXT PRIMARY KEY,
    max_runs INTEGER,
    max_chips INTEGER,
    weight REAL NOT NULL DEFAULT 1.0,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL
);
"""

_JSON_COLUMNS = ("spec", "resolved_spec", "launch_plan", "params",
                 "tags", "meta")


def _loads(text: Optional[str]):
    return json.loads(text) if text else None


class RunRecord:
    """One ``runs`` row. JSON columns decode lazily on first access —
    most scans only touch ``uuid``/``status``/``kind``/timestamps and
    never pay for the (large) serialized spec."""

    __slots__ = ("uuid", "project", "name", "description", "kind",
                 "managed_by", "cache_key", "status", "parent_uuid",
                 "pipeline_uuid", "iteration", "retries", "created_at",
                 "updated_at", "started_at", "finished_at",
                 "_raw", "_decoded")

    def __init__(self, *, uuid: str, project: str, name: Optional[str],
                 kind: Optional[str], status: V1Statuses,
                 parent_uuid: Optional[str], pipeline_uuid: Optional[str],
                 iteration: Optional[int], retries: int, created_at: str,
                 updated_at: str, started_at: Optional[str],
                 finished_at: Optional[str], description: Optional[str] = None,
                 managed_by: str = "agent", cache_key: Optional[str] = None,
                 raw_json: Optional[dict] = None):
        self.uuid = uuid
        self.project = project
        self.name = name
        self.description = description
        self.kind = kind
        self.managed_by = managed_by
        self.cache_key = cache_key
        self.status = status
        self.parent_uuid = parent_uuid
        self.pipeline_uuid = pipeline_uuid
        self.iteration = iteration
        self.retries = retries
        self.created_at = created_at
        self.updated_at = updated_at
        self.started_at = started_at
        self.finished_at = finished_at
        self._raw = raw_json or {}
        self._decoded: dict[str, Any] = {}

    def _json_field(self, field: str):
        try:
            return self._decoded[field]
        except KeyError:
            pass
        value = _loads(self._raw.get(field))
        if value is None:
            if field == "tags":
                value = []
            elif field == "meta":
                value = {}
        self._decoded[field] = value
        return value

    @property
    def spec(self) -> Optional[dict]:
        return self._json_field("spec")

    @property
    def resolved_spec(self) -> Optional[dict]:
        return self._json_field("resolved_spec")

    @property
    def launch_plan(self) -> Optional[dict]:
        return self._json_field("launch_plan")

    @property
    def params(self) -> Optional[dict]:
        return self._json_field("params")

    @property
    def tags(self) -> list:
        return self._json_field("tags")

    @property
    def meta(self) -> dict:
        return self._json_field("meta")

    @property
    def is_done(self) -> bool:
        return self.status in V1Statuses.terminal_values()

    def __repr__(self) -> str:  # debugging aid; JSON stays undecoded
        return (f"RunRecord(uuid={self.uuid!r}, project={self.project!r}, "
                f"kind={self.kind!r}, status={self.status.value!r})")


class _TrackedConnection:
    """Thin proxy over ``sqlite3.Connection`` that counts statements
    into ``Store.stats`` and times them into the
    ``polyaxon_runstore_op_seconds`` histogram. All other attributes
    delegate, so cursors/rowcount/transaction semantics are untouched."""

    __slots__ = ("_raw", "_store")

    def __init__(self, raw: sqlite3.Connection, store: "Store"):
        self._raw = raw
        self._store = store

    def execute(self, sql: str, params: Sequence = ()):  # hot path
        store = self._store
        store.stats["queries"] += 1
        hist = store._op_hist()
        if hist is None:
            return self._raw.execute(sql, params)
        t0 = time.perf_counter()
        try:
            return self._raw.execute(sql, params)
        finally:
            verb = sql.lstrip()[:7].split(None, 1)[0].lower()
            hist.observe(time.perf_counter() - t0, op=verb)

    def executescript(self, script: str):
        self._store.stats["queries"] += 1
        return self._raw.executescript(script)

    def __enter__(self):
        self._raw.__enter__()
        return self

    def __exit__(self, *exc):
        return self._raw.__exit__(*exc)

    def __getattr__(self, name):
        return getattr(self._raw, name)


class Store:
    def __init__(self, path: str = ":memory:"):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._local = threading.local()
        self._lock = threading.RLock()
        # Test/bench-visible statement + materialized-record counters
        # (the sim budget gate and the query-count regression test).
        self.stats: dict[str, int] = {"queries": 0, "rows": 0}
        self._op_hist_cache = None
        self._listeners: list[Callable[[dict], None]] = []
        self._no_batch = False  # deoptimize(): disable txn batching
        with self._conn() as conn:
            conn.executescript(_SCHEMA)
            # Migration: cache_key column for run memoization (upstream
            # V1Cache semantics); older DBs lack it.
            try:
                conn.execute("ALTER TABLE runs ADD COLUMN cache_key TEXT")
                conn.execute(
                    "CREATE INDEX IF NOT EXISTS idx_runs_cache ON runs(cache_key)")
            except sqlite3.OperationalError:
                pass  # already migrated

    def _op_hist(self):
        if self._op_hist_cache is None:
            from polyaxon_tpu_torch.obs import metrics as obs_metrics

            self._op_hist_cache = obs_metrics.runstore_op_hist()
        return self._op_hist_cache

    def _conn(self) -> _TrackedConnection:
        # ':memory:' DBs are per-connection, so a thread-local connection
        # would hand every thread an empty schema — share one connection
        # (all access is serialized by self._lock anyway).
        if self.path == ":memory:":
            conn = getattr(self, "_memory_conn", None)
            if conn is None:
                raw = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
                raw.row_factory = sqlite3.Row
                raw.execute("PRAGMA foreign_keys=ON")
                conn = _TrackedConnection(raw, self)
                self._memory_conn = conn
            return conn
        conn = getattr(self._local, "conn", None)
        if conn is None:
            raw = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
            raw.row_factory = sqlite3.Row
            raw.execute("PRAGMA journal_mode=WAL")
            # Belt over the connect timeout: writers in other PROCESSES
            # (CLI vs agent) spin inside sqlite instead of raising
            # immediately when the WAL write lock is briefly held.
            raw.execute("PRAGMA busy_timeout=30000")
            raw.execute("PRAGMA foreign_keys=ON")
            conn = _TrackedConnection(raw, self)
            self._local.conn = conn
        return conn

    # -- write batching ----------------------------------------------------
    @contextlib.contextmanager
    def transaction(self):
        """Batch every store write inside the block into ONE commit.

        The scheduler wraps each tick in this so N same-tick transitions
        cost one WAL fsync, not N. Reentrant (inner blocks join the
        outer commit); holds the store lock for the duration, which is
        what makes the batch atomic against other writer threads."""
        with self._lock:
            depth = getattr(self._local, "txn_depth", 0)
            if depth or self._no_batch:
                self._local.txn_depth = depth + 1
                try:
                    yield
                finally:
                    self._local.txn_depth = depth
                return
            conn = self._conn()
            self._local.txn_depth = 1
            try:
                with conn:
                    yield
            finally:
                self._local.txn_depth = 0

    @contextlib.contextmanager
    def _write(self):
        """One write op: joins an open ``transaction()`` batch if the
        calling thread has one, else commits immediately (old behavior)."""
        with self._lock:
            conn = self._conn()
            if getattr(self._local, "txn_depth", 0):
                yield conn
            else:
                with conn:
                    yield conn

    # -- delta feed --------------------------------------------------------
    def add_transition_listener(self, fn: Callable[[dict], None]) -> None:
        """Subscribe to status changes. ``fn`` receives
        ``{"uuid", "old", "new", "ts"}`` after each successful
        ``transition`` (inside the store lock, so events arrive in
        commit order). This is the admission controller's incremental
        live-view feed."""
        self._listeners.append(fn)

    def remove_transition_listener(self, fn: Callable[[dict], None]) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _notify(self, event: dict) -> None:
        for fn in list(self._listeners):
            try:
                fn(event)
            except Exception:  # a broken subscriber must not wedge writes
                logger.exception("transition listener failed for %s", event)

    # -- test/bench hooks --------------------------------------------------
    def reset_stats(self) -> None:
        self.stats["queries"] = 0
        self.stats["rows"] = 0

    def deoptimize(self) -> None:
        """Bench hook (``--deopt``): drop the hot composite index and
        disable transaction batching — the 'before' configuration the
        sim budget gate must demonstrably fail on."""
        self._no_batch = True
        with self._write() as conn:
            conn.execute("DROP INDEX IF EXISTS idx_runs_status_created")

    # -- projects ---------------------------------------------------------
    def create_project(self, name: str, description: str = "") -> None:
        with self._write() as conn:
            conn.execute(
                "INSERT OR IGNORE INTO projects(name, description, created_at) VALUES (?,?,?)",
                (name, description, now().isoformat()),
            )

    def list_projects(self) -> list[dict]:
        rows = self._conn().execute("SELECT * FROM projects ORDER BY name").fetchall()
        return [dict(r) for r in rows]

    def has_project(self, name: str) -> bool:
        return self._conn().execute(
            "SELECT 1 FROM projects WHERE name=?", (name,)
        ).fetchone() is not None

    # -- runs -------------------------------------------------------------
    def create_run(
        self,
        *,
        project: str,
        spec: Optional[dict] = None,
        name: Optional[str] = None,
        description: Optional[str] = None,
        kind: Optional[str] = None,
        params: Optional[dict] = None,
        tags: Optional[list[str]] = None,
        meta: Optional[dict] = None,
        parent_uuid: Optional[str] = None,
        pipeline_uuid: Optional[str] = None,
        iteration: Optional[int] = None,
        run_uuid: Optional[str] = None,
    ) -> RunRecord:
        run_uuid = run_uuid or _uuid.uuid4().hex[:12]
        ts = now().isoformat()
        with self._write() as conn:
            conn.execute(
                """INSERT INTO runs(uuid, project, name, description, kind, status,
                    spec, params, tags, meta, parent_uuid, pipeline_uuid, iteration,
                    created_at, updated_at)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                (
                    run_uuid, project, name, description, kind,
                    V1Statuses.CREATED.value,
                    json.dumps(spec) if spec else None,
                    json.dumps(params) if params else None,
                    json.dumps(tags or []),
                    json.dumps(meta or {}),
                    parent_uuid, pipeline_uuid, iteration, ts, ts,
                ),
            )
            conn.execute(
                "INSERT INTO conditions(run_uuid, type, reason, message, created_at)"
                " VALUES (?,?,?,?,?)",
                (run_uuid, V1Statuses.CREATED.value, None, None, ts),
            )
        return self.get_run(run_uuid)

    def find_cached(self, cache_key: str, *, project: str,
                    ttl: Optional[int] = None) -> Optional[RunRecord]:
        """Newest SUCCEEDED run in ``project`` with this cache key
        (within ttl seconds). Project-scoped: memoization must never
        leak artifacts across project namespaces."""
        rows = self._conn().execute(
            "SELECT * FROM runs WHERE cache_key=? AND project=? AND status=? "
            "ORDER BY created_at DESC LIMIT 5",
            (cache_key, project, V1Statuses.SUCCEEDED.value),
        ).fetchall()
        for row in rows:
            record = self._to_record(row)
            if ttl and record.finished_at:
                import datetime as _dt

                finished = _dt.datetime.fromisoformat(record.finished_at)
                if (now() - finished).total_seconds() > ttl:
                    continue
            return record
        return None

    def _to_record(self, row: sqlite3.Row) -> RunRecord:
        self.stats["rows"] += 1
        return RunRecord(
            uuid=row["uuid"],
            project=row["project"],
            name=row["name"],
            description=row["description"],
            kind=row["kind"],
            managed_by=row["managed_by"],
            cache_key=row["cache_key"] if "cache_key" in row.keys() else None,
            status=V1Statuses(row["status"]),
            raw_json={field: row[field] for field in _JSON_COLUMNS},
            parent_uuid=row["parent_uuid"],
            pipeline_uuid=row["pipeline_uuid"],
            iteration=row["iteration"],
            retries=row["retries"],
            created_at=row["created_at"],
            updated_at=row["updated_at"],
            started_at=row["started_at"],
            finished_at=row["finished_at"],
        )

    def get_run(self, run_uuid: str) -> RunRecord:
        row = self._conn().execute("SELECT * FROM runs WHERE uuid=?", (run_uuid,)).fetchone()
        if row is None:
            raise KeyError(f"Run `{run_uuid}` not found")
        return self._to_record(row)

    def get_runs(self, uuids: Sequence[str]) -> list[RunRecord]:
        """Batch point-lookup, (created_at, rowid) ordered. Missing
        uuids are silently skipped (callers diff sets, not indexes)."""
        out: list[RunRecord] = []
        uuids = list(uuids)
        for i in range(0, len(uuids), 500):  # sqlite bind-var headroom
            chunk = uuids[i:i + 500]
            rows = self._conn().execute(
                f"SELECT * FROM runs WHERE uuid IN ({','.join('?' * len(chunk))}) "
                "ORDER BY created_at, rowid", chunk,
            ).fetchall()
            out.extend(self._to_record(r) for r in rows)
        return out

    def list_runs(
        self,
        *,
        project: Optional[str] = None,
        statuses: Optional[list[V1Statuses]] = None,
        pipeline_uuid: Optional[str] = None,
        parent_uuid: Optional[str] = None,
        kind: Optional[str] = None,
        kinds: Optional[Sequence[str]] = None,
        exclude_kinds: Optional[Sequence[str]] = None,
        limit: int = 1000,
        newest_first: bool = False,
    ) -> list[RunRecord]:
        clauses, args = [], []
        if project:
            clauses.append("project=?")
            args.append(project)
        if statuses:
            clauses.append(f"status IN ({','.join('?' * len(statuses))})")
            args.extend(s.value for s in statuses)
        if pipeline_uuid:
            clauses.append("pipeline_uuid=?")
            args.append(pipeline_uuid)
        if parent_uuid:
            clauses.append("parent_uuid=?")
            args.append(parent_uuid)
        if kind:
            clauses.append("kind=?")
            args.append(kind)
        if kinds:
            clauses.append(f"kind IN ({','.join('?' * len(kinds))})")
            args.extend(kinds)
        if exclude_kinds:
            # NULL kind must survive the exclusion (NOT IN drops NULLs).
            clauses.append(
                f"(kind IS NULL OR kind NOT IN "
                f"({','.join('?' * len(exclude_kinds))}))")
            args.extend(exclude_kinds)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        # rowid tie-break: isoformat timestamps collide at same-second
        # submissions, and admission order must be insertion order then.
        order = ("created_at DESC, rowid DESC" if newest_first
                 else "created_at, rowid")
        rows = self._conn().execute(
            f"SELECT * FROM runs{where} ORDER BY {order} LIMIT ?", (*args, limit)
        ).fetchall()
        return [self._to_record(r) for r in rows]

    def list_run_uuids(
        self,
        *,
        statuses: list[V1Statuses],
        limit: int = 100000,
    ) -> list[str]:
        """Key-only projection of the status index: uuids in
        (created_at, rowid) order, no row payload, no JSON. Terminal
        sweeps (e.g. the FAILED restart pass) diff these against their
        in-memory seen-sets and fetch full records only for the
        residue — O(new failures), not O(all failures ever)."""
        rows = self._conn().execute(
            f"SELECT uuid FROM runs WHERE status IN "
            f"({','.join('?' * len(statuses))}) "
            "ORDER BY created_at, rowid LIMIT ?",
            (*[s.value for s in statuses], limit),
        ).fetchall()
        return [r["uuid"] for r in rows]

    def scan_runs(
        self,
        partitions: Sequence[tuple[Sequence[V1Statuses], Optional[Sequence[str]]]],
        *,
        limit: int = 100000,
    ) -> dict[V1Statuses, list[RunRecord]]:
        """The scheduler's one-query tick scan. Each partition is
        ``(statuses, kinds-or-None)``; a kind filter keeps rows of
        other kinds out of the result AT THE SQL LAYER (a 10k-queued
        backlog of plain jobs contributes zero rows to the pipeline
        partition). Results come back grouped by status, each group in
        (created_at, rowid) order; every requested status is present in
        the dict, possibly empty."""
        ors, args = [], []
        for statuses, kinds in partitions:
            clause = f"status IN ({','.join('?' * len(statuses))})"
            args.extend(s.value for s in statuses)
            if kinds:
                clause += f" AND kind IN ({','.join('?' * len(kinds))})"
                args.extend(kinds)
            ors.append(f"({clause})")
        out: dict[V1Statuses, list[RunRecord]] = {}
        for statuses, _ in partitions:
            for status in statuses:
                out.setdefault(status, [])
        rows = self._conn().execute(
            f"SELECT * FROM runs WHERE {' OR '.join(ors)} "
            "ORDER BY created_at, rowid LIMIT ?", (*args, limit),
        ).fetchall()
        for row in rows:
            out[V1Statuses(row["status"])].append(self._to_record(row))
        return out

    def count_runs(self, *, statuses: list[V1Statuses]) -> int:
        row = self._conn().execute(
            f"SELECT COUNT(*) AS n FROM runs WHERE status IN "
            f"({','.join('?' * len(statuses))})",
            [s.value for s in statuses],
        ).fetchone()
        return int(row["n"])

    def update_run(self, run_uuid: str, **fields: Any) -> None:
        allowed = {"name", "description", "kind", "spec", "resolved_spec",
                   "launch_plan", "params", "tags", "meta", "retries",
                   "iteration", "cache_key"}
        sets, args = ["updated_at=?"], [now().isoformat()]
        for key, value in fields.items():
            if key not in allowed:
                raise ValueError(f"Cannot update field `{key}`")
            if key in ("spec", "resolved_spec", "launch_plan", "params", "tags", "meta"):
                value = json.dumps(value) if value is not None else None
            sets.append(f"{key}=?")
            args.append(value)
        args.append(run_uuid)
        with self._write() as conn:
            conn.execute(f"UPDATE runs SET {', '.join(sets)} WHERE uuid=?", args)

    # -- lifecycle --------------------------------------------------------
    def transition(
        self,
        run_uuid: str,
        status: V1Statuses,
        *,
        reason: Optional[str] = None,
        message: Optional[str] = None,
        force: bool = False,
    ) -> bool:
        """Atomically advance a run's status; returns False if illegal."""
        ts = now().isoformat()
        with self._lock:
            with self._write() as conn:
                row = conn.execute("SELECT status FROM runs WHERE uuid=?", (run_uuid,)).fetchone()
                if row is None:
                    raise KeyError(f"Run `{run_uuid}` not found")
                current = V1Statuses(row["status"])
                if not force and not can_transition(current, status):
                    return False
                extra = ""
                args: list[Any] = [status.value, ts]
                if status == V1Statuses.RUNNING:
                    extra = ", started_at=COALESCE(started_at, ?)"
                    args.append(ts)
                elif status in V1Statuses.terminal_values():
                    extra = ", finished_at=?"
                    args.append(ts)
                args.append(run_uuid)
                conn.execute(
                    f"UPDATE runs SET status=?, updated_at=?{extra} WHERE uuid=?", args
                )
                conn.execute(
                    "INSERT INTO conditions(run_uuid, type, reason, message, created_at)"
                    " VALUES (?,?,?,?,?)",
                    (run_uuid, status.value, reason, message, ts),
                )
            # Still inside the store lock: subscribers observe events in
            # commit order (inside an open transaction() batch they see
            # this thread's uncommitted state, which is the same state
            # their own queries on this connection would read).
            self._notify({"uuid": run_uuid, "old": current, "new": status,
                          "ts": ts})
        return True

    def add_condition(
        self,
        run_uuid: str,
        type: str,  # noqa: A002 - mirrors the conditions column
        *,
        reason: Optional[str] = None,
        message: Optional[str] = None,
    ) -> None:
        """Pin a condition WITHOUT a status transition — used by the
        admission pass to surface why a run is still QUEUED (e.g.
        reason=QuotaExceeded) while the status itself stays put."""
        with self._write() as conn:
            conn.execute(
                "INSERT INTO conditions(run_uuid, type, reason, message, created_at)"
                " VALUES (?,?,?,?,?)",
                (run_uuid, type, reason, message, now().isoformat()),
            )

    def last_condition(self, run_uuid: str) -> Optional[dict]:
        row = self._conn().execute(
            "SELECT type, reason, message, created_at FROM conditions "
            "WHERE run_uuid=? ORDER BY id DESC LIMIT 1", (run_uuid,),
        ).fetchone()
        return dict(row) if row is not None else None

    def get_conditions(self, run_uuid: str) -> list[dict]:
        rows = self._conn().execute(
            "SELECT type, reason, message, created_at FROM conditions "
            "WHERE run_uuid=? ORDER BY id", (run_uuid,),
        ).fetchall()
        return [dict(r) for r in rows]

    # -- scheduling catalog (queues + quotas) ------------------------------
    def upsert_queue(
        self,
        name: str,
        *,
        priority: int = 0,
        concurrency: Optional[int] = None,
        preemptible: bool = False,
        description: str = "",
    ) -> dict:
        ts = now().isoformat()
        with self._write() as conn:
            conn.execute(
                """INSERT INTO queues(name, priority, concurrency, preemptible,
                       description, created_at, updated_at)
                   VALUES (?,?,?,?,?,?,?)
                   ON CONFLICT(name) DO UPDATE SET
                       priority=excluded.priority,
                       concurrency=excluded.concurrency,
                       preemptible=excluded.preemptible,
                       description=excluded.description,
                       updated_at=excluded.updated_at""",
                (name, int(priority), concurrency, int(preemptible),
                 description, ts, ts),
            )
        return self.get_queue(name)  # type: ignore[return-value]

    def get_queue(self, name: str) -> Optional[dict]:
        row = self._conn().execute(
            "SELECT * FROM queues WHERE name=?", (name,)).fetchone()
        if row is None:
            return None
        out = dict(row)
        out["preemptible"] = bool(out["preemptible"])
        return out

    def list_queues(self) -> list[dict]:
        rows = self._conn().execute(
            "SELECT * FROM queues ORDER BY priority DESC, name").fetchall()
        out = []
        for row in rows:
            queue = dict(row)
            queue["preemptible"] = bool(queue["preemptible"])
            out.append(queue)
        return out

    def delete_queue(self, name: str) -> bool:
        with self._write() as conn:
            cur = conn.execute("DELETE FROM queues WHERE name=?", (name,))
        return cur.rowcount > 0

    def set_quota(
        self,
        project: str,
        *,
        max_runs: Optional[int] = None,
        max_chips: Optional[int] = None,
        weight: float = 1.0,
    ) -> dict:
        ts = now().isoformat()
        with self._write() as conn:
            conn.execute(
                """INSERT INTO quotas(project, max_runs, max_chips, weight,
                       created_at, updated_at)
                   VALUES (?,?,?,?,?,?)
                   ON CONFLICT(project) DO UPDATE SET
                       max_runs=excluded.max_runs,
                       max_chips=excluded.max_chips,
                       weight=excluded.weight,
                       updated_at=excluded.updated_at""",
                (project, max_runs, max_chips, float(weight), ts, ts),
            )
        return self.get_quota(project)  # type: ignore[return-value]

    def get_quota(self, project: str) -> Optional[dict]:
        row = self._conn().execute(
            "SELECT * FROM quotas WHERE project=?", (project,)).fetchone()
        return dict(row) if row is not None else None

    def list_quotas(self) -> list[dict]:
        rows = self._conn().execute(
            "SELECT * FROM quotas ORDER BY project").fetchall()
        return [dict(r) for r in rows]

    def delete_quota(self, project: str) -> bool:
        with self._write() as conn:
            cur = conn.execute("DELETE FROM quotas WHERE project=?", (project,))
        return cur.rowcount > 0

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
        mem = getattr(self, "_memory_conn", None)
        if mem is not None:
            mem.close()
            self._memory_conn = None
