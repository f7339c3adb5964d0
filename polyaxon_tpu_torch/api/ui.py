"""The runs dashboard served by the API server at ``/`` and ``/ui``:
``DASHBOARD_HTML`` is a copy of ``polyaxon_tpu/api/ui.py``'s, byte for
byte (it reads the same REST surface, which the port's server answers
alike). One static page: run list + status filter, per-run metric charts
(inline SVG), raw-table fallback per chart, and a live log tail over the
SSE streams endpoint.
"""

from __future__ import annotations

DASHBOARD_HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>polyaxon_tpu — runs</title>
<style>
  :root {
    color-scheme: light;
    --page: #f9f9f7; --surface: #fcfcfb;
    --ink: #0b0b0b; --ink-2: #52514e; --muted: #898781;
    --grid: #e1e0d9; --axis: #c3c2b7; --ring: rgba(11,11,11,0.10);
    --series-1: #2a78d6; --series-2: #d07c2e; --series-3: #2f9e77;
    --series-4: #8e67c5; --series-5: #c5527a; --series-6: #8a8a2a;
    --status-good: #0ca30c; --status-warning: #fab219;
    --status-serious: #ec835a; --status-critical: #d03b3b;
  }
  @media (prefers-color-scheme: dark) {
    :root:not([data-theme="light"]) {
      color-scheme: dark;
      --page: #0d0d0d; --surface: #1a1a19;
      --ink: #ffffff; --ink-2: #c3c2b7; --muted: #898781;
      --grid: #2c2c2a; --axis: #383835; --ring: rgba(255,255,255,0.10);
      --series-1: #3987e5; --series-2: #e08a3a; --series-3: #37b389;
      --series-4: #a07ad6; --series-5: #d66a91; --series-6: #a3a33a;
    }
  }
  :root[data-theme="dark"] {
    color-scheme: dark;
    --page: #0d0d0d; --surface: #1a1a19;
    --ink: #ffffff; --ink-2: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --axis: #383835; --ring: rgba(255,255,255,0.10);
    --series-1: #3987e5; --series-2: #e08a3a; --series-3: #37b389;
    --series-4: #a07ad6; --series-5: #d66a91; --series-6: #a3a33a;
  }
  * { box-sizing: border-box; }
  body { margin: 0; background: var(--page); color: var(--ink);
         font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif; }
  header { display: flex; align-items: center; gap: 12px;
           padding: 14px 20px; border-bottom: 1px solid var(--ring); }
  header h1 { font-size: 16px; margin: 0; font-weight: 650; }
  header .spacer { flex: 1; }
  select, button, input[type="search"] {
    font: inherit; color: var(--ink); background: var(--surface);
    border: 1px solid var(--ring); border-radius: 6px; padding: 4px 10px;
  }
  select, button { cursor: pointer; }
  input[type="search"] { min-width: 180px; }
  main { padding: 16px 20px; max-width: 1100px; margin: 0 auto; }
  .tiles { display: flex; gap: 12px; flex-wrap: wrap; margin-bottom: 16px; }
  .tile { background: var(--surface); border: 1px solid var(--ring);
          border-radius: 8px; padding: 10px 16px; min-width: 120px; }
  .tile .v { font-size: 22px; font-weight: 650; }
  .tile .k { color: var(--ink-2); font-size: 12px; }
  .history { background: var(--surface); border: 1px solid var(--ring);
             border-radius: 8px; padding: 8px 14px; margin-bottom: 16px;
             font-size: 12px; }
  .history .k { color: var(--ink-2); margin-right: 10px; }
  .hist-line { display: inline-flex; gap: 8px; margin-right: 18px;
               align-items: baseline; }
  .hist-key { color: var(--muted); }
  .hist-spark { font-family: monospace; letter-spacing: 1px; }
  .hist-last { font-variant-numeric: tabular-nums; font-weight: 600; }
  table { width: 100%; border-collapse: collapse; background: var(--surface);
          border: 1px solid var(--ring); border-radius: 8px; overflow: hidden; }
  th { text-align: left; color: var(--muted); font-weight: 500; font-size: 12px; }
  th, td { padding: 7px 12px; border-bottom: 1px solid var(--grid); }
  td.num { font-variant-numeric: tabular-nums; }
  tr.run { cursor: pointer; }
  tr.run:hover td { background: color-mix(in srgb, var(--ink) 4%, transparent); }
  .pill { display: inline-flex; align-items: center; gap: 6px; font-size: 12px;
          color: var(--ink-2); }
  .pill .dot { width: 8px; height: 8px; border-radius: 50%; }
  #detail { margin-top: 20px; }
  .charts { display: grid; grid-template-columns: repeat(auto-fill, minmax(320px, 1fr));
            gap: 14px; margin-top: 10px; }
  .chart { background: var(--surface); border: 1px solid var(--ring);
           border-radius: 8px; padding: 10px 12px; }
  .chart h3 { margin: 0 0 4px; font-size: 13px; font-weight: 600; }
  .chart .sub { color: var(--muted); font-size: 11px; }
  .chart svg { display: block; width: 100%; height: 150px; }
  .chart .tbl { display: none; max-height: 150px; overflow: auto; }
  .chart.show-table svg { display: none; }
  .chart.show-table .tbl { display: block; }
  .chart .tools { float: right; }
  .chart .tools button { font-size: 11px; padding: 1px 7px; }
  .tooltip { position: fixed; pointer-events: none; background: var(--surface);
             border: 1px solid var(--ring); border-radius: 6px; padding: 4px 8px;
             font-size: 12px; box-shadow: 0 2px 8px rgba(0,0,0,.15); display: none;
             z-index: 10; }
  #logs { background: var(--surface); border: 1px solid var(--ring);
          border-radius: 8px; margin-top: 14px; padding: 10px 12px;
          max-height: 260px; overflow: auto; white-space: pre-wrap;
          font: 12px/1.5 ui-monospace, monospace; color: var(--ink-2); }
  a.uuid { color: var(--series-1); text-decoration: none; }
  .legend { display: flex; gap: 12px; flex-wrap: wrap; font-size: 12px;
            color: var(--ink-2); margin: 4px 0 2px; }
  .legend .key { display: inline-flex; align-items: center; gap: 5px; }
  .legend .swatch { width: 10px; height: 10px; border-radius: 2px; }
  .bracket { background: var(--surface); border: 1px solid var(--ring);
             border-radius: 8px; padding: 10px 14px; margin-top: 12px; }
  .bracket h3 { margin: 0 0 6px; font-size: 13px; font-weight: 600; }
  .rung { display: flex; align-items: baseline; gap: 10px; padding: 5px 0;
          border-top: 1px solid var(--grid); flex-wrap: wrap; }
  .rung .rname { min-width: 130px; color: var(--ink-2); font-size: 12px; }
  .chip { display: inline-flex; align-items: center; gap: 6px;
          background: color-mix(in srgb, var(--ink) 4%, transparent);
          border: 1px solid var(--grid); border-radius: 12px;
          padding: 2px 9px; font-size: 12px; cursor: pointer; }
  .chip:hover { border-color: var(--axis); }
  .chip .val { font-variant-numeric: tabular-nums; color: var(--ink); }
  td.cmp, th.cmp { width: 26px; padding-right: 0; }
  .dag svg { display: block; width: 100%; }
  .dag .dagnode { cursor: pointer; }
  .dag .dagnode.inert { cursor: default; }
  .dag .dagnode rect { fill: var(--surface); stroke-width: 1.5; rx: 7; }
  .dag .dagnode:hover rect { filter: brightness(1.06); }
  .dag .dagnode text { fill: var(--ink); font-size: 12px; }
  .dag .dagnode .st { fill: var(--ink-2); font-size: 10px; }
  .dag .edge { fill: none; stroke: var(--axis); stroke-width: 1.3; }
  .tl { background: var(--surface); border: 1px solid var(--ring);
        border-radius: 8px; padding: 10px 14px; margin-top: 12px; }
  .tl h3 { margin: 0 0 6px; font-size: 13px; font-weight: 600; }
  .tl-row { display: flex; align-items: center; gap: 8px; padding: 2px 0;
            font-size: 12px; }
  .tl-name { flex: 0 0 180px; overflow: hidden; text-overflow: ellipsis;
             white-space: nowrap; color: var(--ink-2); }
  .tl-track { position: relative; flex: 1; height: 12px;
              background: color-mix(in srgb, var(--ink) 4%, transparent);
              border-radius: 3px; }
  .tl-bar { position: absolute; top: 1px; height: 10px; min-width: 2px;
            border-radius: 3px; background: var(--series-1); }
  .tl-bar.err { background: var(--bad, #c0392b); }
  .tl-ev { position: absolute; top: 2px; width: 5px; height: 8px;
           border-radius: 50%; background: var(--ink-2); }
  .tl-ev.chaos { background: var(--bad, #c0392b); }
  .tl-dur { flex: 0 0 76px; text-align: right; color: var(--ink-2);
            font-variant-numeric: tabular-nums; }
  .alert { display: flex; gap: 10px; align-items: baseline;
           padding: 6px 10px; margin: 4px 0; border-radius: 6px;
           border-left: 4px solid var(--status-warning);
           background: color-mix(in srgb,
             var(--status-warning) 12%, transparent); }
  .alert.page { border-left-color: var(--status-critical);
                background: color-mix(in srgb,
                  var(--status-critical) 12%, transparent); }
  .alert .alert-val { font-variant-numeric: tabular-nums;
                      color: var(--ink-2); }
  .alert .alert-desc { color: var(--ink-2); }
</style>
</head>
<body>
<header>
  <h1>polyaxon_tpu</h1>
  <span class="spacer"></span>
  <input id="tokenBox" type="password" placeholder="API token" hidden
         aria-label="bearer token for an auth-enabled server">
  <input id="searchBox" type="search" placeholder="filter runs…"
         aria-label="filter runs by name, kind, uuid, or tag">
  <select id="projectFilter" aria-label="project filter">
    <option>default</option>
  </select>
  <select id="statusFilter" aria-label="status filter">
    <option value="">all statuses</option>
    <option>running</option><option>succeeded</option>
    <option>failed</option><option>stopped</option>
    <option>queued</option><option>preempted</option>
  </select>
  <button id="compareBtn" hidden>compare</button>
  <button id="refresh">refresh</button>
  <button id="themeToggle" aria-label="toggle theme">◐</button>
</header>
<main>
  <div class="tiles" id="tiles"></div>
  <div id="historyPanel"></div>
  <div id="alertsPanel" aria-live="polite"></div>
  <div id="projectPanel"></div>
  <div id="slicesPanel"></div>
  <table id="runs">
    <thead><tr>
      <th class="cmp" aria-label="compare"></th>
      <th>run</th><th>name</th><th>kind</th><th>project</th>
      <th>status</th><th>created</th>
    </tr></thead>
    <tbody></tbody>
  </table>
  <section id="detail"></section>
</main>
<div class="tooltip" id="tooltip"></div>
<script>
"use strict";
// Status → {color role, glyph}: icon + label always travel together.
const STATUS = {
  succeeded: ["var(--status-good)", "✓"],
  running:   ["var(--series-1)", "▶"],
  queued:    ["var(--muted)", "…"],
  scheduled: ["var(--muted)", "…"],
  starting:  ["var(--muted)", "…"],
  compiled:  ["var(--muted)", "…"],
  created:   ["var(--muted)", "…"],
  stopped:   ["var(--status-warning)", "■"],
  preempted: ["var(--status-warning)", "⏸"],
  failed:    ["var(--status-critical)", "✕"],
};
const $ = (sel, el) => (el || document).querySelector(sel);
// Auth-enabled servers (plx server --auth-token/--owner-token): the
// token lives in localStorage and rides every fetch; a 401 reveals
// the header's token box so the dashboard is usable without curl.
const getToken = () => localStorage.getItem("plx_token") || "";
const OWNER = localStorage.getItem("plx_owner") || "default";
const base = (project) => `/api/v1/${encodeURIComponent(OWNER)}/${encodeURIComponent(project || "default")}`;
// Header-less browser loads (img/a/EventSource) carry the credential
// as ?token= — the server accepts it on the artifacts + SSE routes.
// URLs leak into proxy logs/history/Referer, so they get a SHORT-LIVED
// derived stream token (minted over an authed header call, refreshed
// before expiry), never the primary secret. Until the first mint
// resolves, URLs fall back to the primary so nothing breaks.
let streamTok = "", streamTokExp = 0, streamTokPending = null;
function refreshStreamToken() {
  if (!getToken()) return Promise.resolve();
  if (streamTok && Date.now() < streamTokExp - 30000) return Promise.resolve();
  if (streamTokPending) return streamTokPending;
  streamTokPending = api("/api/v1/stream-token").then(d => {
    streamTok = d.token;
    streamTokExp = Date.now() + (d.expiresIn || 300) * 1000;
  }).catch(() => {}).finally(() => { streamTokPending = null; });
  return streamTokPending;
}
// First-paint ordering (ADVICE r5 #4): every URL-constructing render
// awaits the mint — retrying once on failure — BEFORE building its
// first SSE/artifact URLs, so the primary secret never rides a URL
// merely because the eager mint hadn't resolved yet. After two failed
// mints tokenQS still falls back to the primary (servers without the
// mint route would otherwise lose SSE/images entirely) — but that is
// now a capability fallback, not a race.
async function ensureStreamToken() {
  if (!getToken()) return;
  await refreshStreamToken();
  if (!(streamTok && Date.now() < streamTokExp)) await refreshStreamToken();
}
const tokenQS = (sep) => {
  if (!getToken()) return "";
  refreshStreamToken();  // async refill for the NEXT url
  const t = (streamTok && Date.now() < streamTokExp)
    ? streamTok : getToken();
  return `${sep}token=${encodeURIComponent(t)}`;
};
const api = (p) => fetch(p, getToken()
    ? {headers: {Authorization: `Bearer ${getToken()}`}} : {})
  .then(r => {
    if (r.status === 401) {
      const box = $("#tokenBox");
      if (box) box.hidden = false;
      throw new Error("401 (set the API token, top right)");
    }
    if (!r.ok) throw new Error(r.status);
    return r.json();
  });
// All user-controlled strings (run names, projects, metric names) go
// through esc() before any innerHTML interpolation — stored XSS guard.
const esc = (s) => String(s ?? "").replace(/[&<>"']/g,
  c => ({"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[c]));

function wireRunChips(root) {
  // role=button chips navigate on click AND Enter/Space — one wiring
  // for the sweep/bracket chips, DAG nodes, and slice-pool gangs.
  for (const chip of root.querySelectorAll(
      ".chip[data-uuid], .dagnode[data-uuid], .lingnode[data-uuid]")) {
    if (!chip.dataset.uuid) continue;  // unknown lineage node: inert
    chip.onclick = () => showRun(chip.dataset.uuid);
    chip.onkeydown = (ev) => {
      if (ev.key === "Enter" || ev.key === " ") {
        ev.preventDefault();
        showRun(chip.dataset.uuid);
      }
    };
  }
}

function pill(status) {
  const [color, glyph] = STATUS[status] || ["var(--muted)", "•"];
  return `<span class="pill"><span class="dot" style="background:${color}"></span>${glyph} ${esc(status)}</span>`;
}

function tile(k, v) {
  return `<div class="tile"><div class="v">${v}</div><div class="k">${k}</div></div>`;
}

let lastRows = [];      // last successful fetch — search filters this
let lastProjects = "";  // rendered option set, rebuilt only on change

// Alerts banner (obs.rules): firing alerts from /api/v1/alerts render
// above the run table — a degraded cluster announces itself before
// the operator goes digging. Quiet when nothing fires.
async function loadAlerts() {
  const el = $("#alertsPanel");
  let data;
  try { data = await api("/api/v1/alerts"); }
  catch (e) { return; }  // transient/auth failure: keep the last banner
  const firing = data.alerts || [];
  if (!firing.length) { el.innerHTML = ""; return; }
  el.innerHTML = `<div class="alerts">` + firing.map(a => `
    <div class="alert ${esc(a.severity)}" role="alert">
      <strong>${esc(a.rule)}</strong>
      <span class="alert-val">value=${esc(a.value)} threshold=${esc(a.threshold)}</span>
      <span class="alert-desc">${esc(a.description)}</span>
    </div>`).join("") + `</div>`;
}

// History tile (obs.history): a sparkline over the shared metrics-
// history ring — queue depth over the trailing 15m shows the operator
// the SHAPE of the backlog, not just its current number. Quiet until
// the ring has sampled the series.
const SPARK = "▁▂▃▄▅▆▇█";
function spark(values) {
  const lo = Math.min(...values), hi = Math.max(...values);
  if (!(hi - lo > 1e-12)) return SPARK[0].repeat(values.length);
  return values.map(v =>
    SPARK[Math.floor((v - lo) / (hi - lo) * (SPARK.length - 1))]).join("");
}
async function loadHistory() {
  const el = $("#historyPanel");
  let data;
  try {
    data = await api(
      "/api/v1/metrics/history?name=polyaxon_queue_depth&window=15m");
  } catch (e) { el.innerHTML = ""; return; }  // not sampled yet
  const series = (data.metric || {}).series || {};
  const lines = Object.entries(series).map(([key, pts]) => {
    const vals = pts.map(p =>
      typeof p[1] === "object" ? (p[1].count || 0) : p[1]);
    if (!vals.length) return "";
    return `<div class="hist-line"><span class="hist-key">${esc(key || "fleet")}</span><span class="hist-spark">${spark(vals)}</span><span class="hist-last">${vals[vals.length - 1]}</span></div>`;
  }).filter(Boolean);
  el.innerHTML = lines.length
    ? `<div class="history"><span class="k">queue depth · 15m</span>${lines.join("")}</div>`
    : "";
}

async function loadRuns() {
  const status = $("#statusFilter").value;
  const q = status ? `?status=${encodeURIComponent(status)}` : "";
  // The list route is project-scoped; the dropdown picks which one
  // (run DETAIL stays uuid-addressed, so everything else is unchanged).
  const projSel = $("#projectFilter");
  let projects;
  try { projects = (await api("/api/v1/projects")).map(p => p.name).sort(); }
  catch (e) { projects = null; }  // transient failure: keep the old list
  if (projects && projects.length && projects.join("\n") !== lastProjects) {
    // Rebuild only on a real change — an unconditional rebuild every
    // poll would close the dropdown under the user's cursor.
    const prev = projSel.value;
    const current = projects.includes(prev) ? prev : projects[0];
    projSel.innerHTML = projects.map(p =>
      `<option${p === current ? " selected" : ""}>${esc(p)}</option>`
    ).join("");
    lastProjects = projects.join("\n");
  }
  const project = projSel.value || "default";
  try {
    const data = await api(
      `${base(project)}/runs${q}`);
    lastRows = data.results || [];
  } catch (e) {
    // 401 already revealed the token box; a 403 means the credential
    // does not cover this owner path — surface it instead of showing
    // a silently empty table ("owner:token" scopes the dashboard).
    if (String(e.message).startsWith("403")) {
      const box = $("#tokenBox");
      box.hidden = false;
      box.placeholder = "owner:token (403 for this owner)";
    }
    return;  // otherwise transient: keep the last good table on screen
  }
  renderRuns();
  renderSlices();
  loadAlerts();
  loadHistory();
}

function renderRuns() {
  const keep = new Set(selectedRuns().map(r => r.uuid));  // survive refresh
  let rows = lastRows;
  // Free-text filter over name/kind/uuid/tags — purely client-side,
  // so keystrokes never trigger network I/O.
  const needle = $("#searchBox").value.trim().toLowerCase();
  if (needle)
    rows = rows.filter(r =>
      [r.name, r.kind, r.uuid, ...(r.tags || [])].some(
        v => String(v ?? "").toLowerCase().includes(needle)));
  const counts = {};
  for (const r of rows) counts[r.status] = (counts[r.status] || 0) + 1;
  // Project-level health tiles: success rate over terminal runs and
  // median wall time of succeeded runs, alongside the status counts.
  const terminal = rows.filter(r => r.finished_at);
  const ok = terminal.filter(r => r.status === "succeeded");
  const rate = terminal.length
    ? Math.round(100 * ok.length / terminal.length) + "%" : "–";
  const walls = ok.map(r => toEpoch(r.finished_at) - toEpoch(r.created_at))
    .filter(w => w >= 0).sort((a, b) => a - b);
  const med = walls.length ? fmtDur(walls[walls.length >> 1]) : "–";
  $("#tiles").innerHTML =
    tile("total", rows.length) +
    ["running", "succeeded", "failed"].map(s => tile(s, counts[s] || 0)).join("") +
    tile("success rate", rate) + tile("median wall", med);
  $("#projectPanel").innerHTML = projectPanel(rows);
  $("#runs tbody").innerHTML = rows.map(r => `
    <tr class="run" data-uuid="${esc(r.uuid)}">
      <td class="cmp"><input type="checkbox" class="cmpBox"
          data-uuid="${esc(r.uuid)}" data-name="${esc(r.name || String(r.uuid).slice(0, 8))}"
          aria-label="select for comparison"></td>
      <td><a class="uuid">${esc(String(r.uuid).slice(0, 12))}</a></td>
      <td>${esc(r.name)}</td><td>${esc(r.kind)}</td><td>${esc(r.project)}</td>
      <td>${pill(r.status)}</td>
      <td class="num">${isFinite(toEpoch(r.created_at)) ? new Date(toEpoch(r.created_at) * 1000).toLocaleString() : ""}</td>
    </tr>`).join("");
  for (const tr of document.querySelectorAll("tr.run"))
    tr.onclick = (ev) => {
      if (ev.target.classList.contains("cmpBox")) return;
      showRun(tr.dataset.uuid);
    };
  for (const box of document.querySelectorAll(".cmpBox")) {
    box.checked = keep.has(box.dataset.uuid);
    box.onchange = updateCompareBtn;
  }
  updateCompareBtn();
}

function toEpoch(v) {
  // Records serialize timestamps as ISO-8601 strings (store.py
  // isoformat); accept epoch numbers too. NaN for absent/unparsable.
  if (v == null) return NaN;
  if (typeof v === "number") return v;
  return Date.parse(v) / 1000;
}

function fmtDur(s) {
  if (s < 90) return Math.round(s) + "s";
  if (s < 5400) return (s / 60).toPrecision(2) + "m";
  return (s / 3600).toPrecision(2) + "h";
}

function projectPanel(rows) {
  // Project activity: runs created per day over the last 14 days,
  // stacked by outcome (succeeded / failed / other). Pure client-side
  // over the already-fetched list — no extra API round trips.
  const DAYS = 14, DAY = 86400;
  const today = Math.floor(Date.now() / 1000 / DAY);
  const buckets = Array.from({length: DAYS}, () => ({ok: 0, bad: 0, other: 0}));
  let seen = 0;
  for (const r of rows) {
    const created = toEpoch(r.created_at);
    if (!isFinite(created)) continue;
    const age = today - Math.floor(created / DAY);
    if (age < 0 || age >= DAYS) continue;
    seen++;
    const b = buckets[DAYS - 1 - age];
    if (r.status === "succeeded") b.ok++;
    else if (r.status === "failed" || r.status === "upstream_failed") b.bad++;
    else b.other++;
  }
  if (!seen) return "";
  const W = 980, H = 88, P = {l: 30, r: 6, t: 6, b: 16};
  const max = Math.max(...buckets.map(b => b.ok + b.bad + b.other), 1);
  const bw = (W - P.l - P.r) / DAYS;
  const sy = n => (H - P.t - P.b) * n / max;
  const bars = buckets.map((b, i) => {
    const x = P.l + i * bw + 2, w = Math.max(bw - 4, 2);
    let y = H - P.b;
    const seg = (n, color) => {
      if (!n) return "";
      const h = sy(n); y -= h;
      return `<rect x="${x}" y="${y}" width="${w}" height="${h}" fill="${color}" rx="1"/>`;
    };
    const day = new Date((today - (DAYS - 1 - i)) * DAY * 1000);
    const lbl = (i % 2 === 0)
      ? `<text x="${x + w / 2}" y="${H - 3}" text-anchor="middle" font-size="9" fill="var(--muted)">${day.getMonth() + 1}/${day.getDate()}</text>`
      : "";
    return seg(b.ok, "var(--status-good)") + seg(b.bad, "var(--status-critical)")
      + seg(b.other, "var(--muted)") + lbl;
  }).join("");
  const axis = `<text x="2" y="${P.t + 9}" font-size="9" fill="var(--muted)">${max}</text>
    <line x1="${P.l}" y1="${H - P.b}" x2="${W - P.r}" y2="${H - P.b}" stroke="var(--axis)" stroke-width="1"/>`;
  return `<div class="bracket">
    <h3>project activity · last ${DAYS} days · ${seen} runs</h3>
    <svg viewBox="0 0 ${W} ${H}" width="100%" height="${H}" role="img"
         aria-label="runs per day stacked by outcome">${axis}${bars}</svg>
  </div>`;
}

function selectedRuns() {
  return [...document.querySelectorAll(".cmpBox:checked")]
    .map(b => ({uuid: b.dataset.uuid, name: b.dataset.name}));
}

function updateCompareBtn() {
  const n = selectedRuns().length;
  const btn = $("#compareBtn");
  btn.hidden = n < 2;
  btn.textContent = `compare ${n} runs`;
}

// Shared chart geometry: one source of truth for scales, grid, and
// baseline across lineChart, overlayChart, and the tooltip math.
const CW = 320, CH = 150, CP = {l: 42, r: 10, t: 8, b: 20};
const fmtNum = v => Math.abs(v) >= 1000 ? v.toPrecision(4) : +v.toPrecision(3);

function chartFrame(points) {
  const xs = points.map(p => p.step), ys = points.map(p => p.value);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  let y0 = Math.min(...ys), y1 = Math.max(...ys);
  if (y0 === y1) { y0 -= 1; y1 += 1; }
  const sx = s => CP.l + (CW - CP.l - CP.r) * (x1 === x0 ? 0.5 : (s - x0) / (x1 - x0));
  const sy = v => CH - CP.b - (CH - CP.t - CP.b) * ((v - y0) / (y1 - y0));
  const grid = [0, 0.5, 1].map(f => {
    const y = sy(y0 + f * (y1 - y0));
    return `<line x1="${CP.l}" y1="${y}" x2="${CW - CP.r}" y2="${y}" stroke="var(--grid)" stroke-width="1"/>
            <text x="${CP.l - 6}" y="${y + 4}" text-anchor="end" font-size="10" fill="var(--muted)">${fmtNum(y0 + f * (y1 - y0))}</text>`;
  }).join("");
  const baseline = `<line x1="${CP.l}" y1="${CH - CP.b}" x2="${CW - CP.r}" y2="${CH - CP.b}" stroke="var(--axis)" stroke-width="1"/>
    <text x="${CW - CP.r}" y="${CH - 6}" text-anchor="end" font-size="10" fill="var(--muted)">step ${x1}</text>`;
  const linePath = pts => pts.map((p, i) =>
    `${i ? "L" : "M"}${sx(p.step).toFixed(1)},${sy(p.value).toFixed(1)}`).join("");
  return {x0, x1, y0, y1, sx, sy, grid, baseline, linePath};
}

function lineChart(name, points) {
  // Single series per chart: the title names it, so no legend box.
  const W = CW, H = CH, P = CP, fmt = fmtNum;
  const ys = points.map(p => p.value);
  const f = chartFrame(points);
  const {x0, x1, grid} = f;
  const path = f.linePath(points);
  const table = `<table><thead><tr><th>step</th><th>value</th></tr></thead><tbody>
    ${points.map(p => `<tr><td class="num">${p.step}</td><td class="num">${fmt(p.value)}</td></tr>`).join("")}
  </tbody></table>`;
  return `<div class="chart" data-name="${esc(name)}">
    <div class="tools"><button class="toTable">table</button></div>
    <h3>${esc(name)}</h3>
    <div class="sub">${points.length} points · last ${fmt(ys[ys.length - 1])}</div>
    <svg viewBox="0 0 ${W} ${H}" data-points='${esc(JSON.stringify(points))}'
         data-x0="${x0}" data-x1="${x1}" role="img" aria-label="${esc(name)} over steps">
      ${grid}
      ${f.baseline}
      <path d="${path}" fill="none" stroke="var(--series-1)" stroke-width="2"
            stroke-linejoin="round" stroke-linecap="round"/>
      <line class="xhair" y1="${P.t}" y2="${H - P.b}" stroke="var(--axis)" stroke-width="1" visibility="hidden"/>
      <circle class="dot" r="4" fill="var(--series-1)" stroke="var(--surface)" stroke-width="2" visibility="hidden"/>
    </svg>
    <div class="tbl">${table}</div>
  </div>`;
}

function wireChart(el) {
  $(".toTable", el).onclick = () => el.classList.toggle("show-table");
  const svg = $("svg", el);
  if (!svg) return;
  const points = JSON.parse(svg.dataset.points);
  const tooltip = $("#tooltip");
  svg.addEventListener("mousemove", (ev) => {
    const rect = svg.getBoundingClientRect();
    const W = CW, P = CP;
    const fx = (ev.clientX - rect.left) / rect.width * W;
    const x0 = +svg.dataset.x0, x1 = +svg.dataset.x1;
    const step = x0 + (fx - P.l) / (W - P.l - P.r) * (x1 - x0);
    let best = points[0];
    for (const p of points) if (Math.abs(p.step - step) < Math.abs(best.step - step)) best = p;
    const ys = points.map(p => p.value);
    let y0 = Math.min(...ys), y1 = Math.max(...ys);
    if (y0 === y1) { y0 -= 1; y1 += 1; }
    const sx = P.l + (W - P.l - P.r) * (x1 === x0 ? 0.5 : (best.step - x0) / (x1 - x0));
    const sy = CH - P.b - (CH - P.t - P.b) * ((best.value - y0) / (y1 - y0));
    const xh = $(".xhair", svg), dot = $(".dot", svg);
    xh.setAttribute("x1", sx); xh.setAttribute("x2", sx); xh.setAttribute("visibility", "visible");
    dot.setAttribute("cx", sx); dot.setAttribute("cy", sy); dot.setAttribute("visibility", "visible");
    tooltip.style.display = "block";
    tooltip.style.left = (ev.clientX + 12) + "px";
    tooltip.style.top = (ev.clientY - 10) + "px";
    tooltip.textContent = `step ${best.step} · ${+best.value.toPrecision(4)}`;
  });
  svg.addEventListener("mouseleave", () => {
    tooltip.style.display = "none";
    $(".xhair", svg).setAttribute("visibility", "hidden");
    $(".dot", svg).setAttribute("visibility", "hidden");
  });
}

function histChart(name, ev) {
  // Single-hue bar chart of the latest histogram event: thin bars,
  // 2px surface gaps, baseline axis, per-bar hover via <title>.
  const W = 320, H = 150, P = {l: 42, r: 10, t: 8, b: 20};
  const counts = ev.counts, edges = ev.edges;
  const maxC = Math.max(...counts, 1);
  const bw = (W - P.l - P.r) / counts.length;
  const fmt = v => +Number(v).toPrecision(3);
  const bars = counts.map((c, i) => {
    const bh = (H - P.t - P.b) * (c / maxC);
    return `<rect x="${(P.l + i * bw + 1).toFixed(1)}" y="${(H - P.b - bh).toFixed(1)}"
      width="${Math.max(bw - 2, 1).toFixed(1)}" height="${bh.toFixed(1)}"
      rx="2" fill="var(--series-1)"><title>[${fmt(edges[i])}, ${fmt(edges[i + 1])}): ${c}</title></rect>`;
  }).join("");
  return `<div class="chart">
    <h3>${esc(name)}</h3>
    <div class="sub">histogram · ${counts.reduce((a, b) => a + b, 0)} values${ev.step != null ? ` · step ${ev.step}` : ""}</div>
    <svg viewBox="0 0 ${W} ${H}" role="img" aria-label="${esc(name)} histogram">
      <line x1="${P.l}" y1="${H - P.b}" x2="${W - P.r}" y2="${H - P.b}" stroke="var(--axis)" stroke-width="1"/>
      <text x="${P.l}" y="${H - 6}" font-size="10" fill="var(--muted)">${fmt(edges[0])}</text>
      <text x="${W - P.r}" y="${H - 6}" text-anchor="end" font-size="10" fill="var(--muted)">${fmt(edges[edges.length - 1])}</text>
      ${bars}
    </svg>
  </div>`;
}

function imageCard(uuid, name, ev) {
  // URL-encode each path segment (names may carry spaces/#/%), then
  // HTML-escape for the attribute context.
  const rel = String(ev.path).split("/").map(encodeURIComponent).join("/");
  const src = esc(`${base()}/runs/${encodeURIComponent(uuid)}/artifacts/${rel}${tokenQS('?')}`);
  return `<div class="chart">
    <h3>${esc(name)}</h3>
    <div class="sub">image${ev.step != null ? ` · step ${ev.step}` : ""}</div>
    <img src="${src}" alt="${esc(name)}" style="max-width:100%;border-radius:4px">
  </div>`;
}

function fmtSize(n) {
  if (n == null) return "";
  if (n >= 1 << 30) return (n / (1 << 30)).toFixed(2) + " GB";
  if (n >= 1 << 20) return (n / (1 << 20)).toFixed(1) + " MB";
  if (n >= 1024) return (n / 1024).toFixed(1) + " KB";
  return n + " B";
}

function artUrl(uuid, rel) {
  const enc = String(rel).split("/").map(encodeURIComponent).join("/");
  return `${base()}/runs/${encodeURIComponent(uuid)}/artifacts/${enc}${tokenQS('?')}`;
}

function artifactsPanel(uuid, lineage, files) {
  // Run-detail artifact browser: lineage records (kind/name/size) with
  // download links through the streams service, inline <img> for
  // image artifacts and open-in-tab for html (served with real
  // content types), plus the full file listing.
  if (!lineage.length && !files.length) return "";
  const isImg = (p) => /\.(png|jpe?g|gif|svg|webp)$/i.test(p);
  const isHtml = (p) => /\.html?$/i.test(p);
  const rows = lineage.map((r) => {
    const rel = r.rel_path;
    const label = esc(r.name || rel || "(external)");
    // Directories aren't downloadable through the file route — their
    // contents appear in the file listing below.
    const link = rel && !r.is_dir
      ? `<a class="uuid" href="${esc(artUrl(uuid, rel))}" download>${label}</a>`
      : label;
    let preview = "";
    if (r.is_dir) {
      preview = "";
    } else if (rel && isImg(rel)) {
      preview = `<img src="${esc(artUrl(uuid, rel))}" alt="${label}"
                   style="max-height:72px;border-radius:4px">`;
    } else if (rel && isHtml(rel)) {
      // Inline render, sandboxed twice over: iframe sandbox attr here
      // plus the server's CSP sandbox header on the artifact route —
      // run-produced html draws but cannot script or reach the API.
      preview = `<iframe src="${esc(artUrl(uuid, rel))}" sandbox
          title="${label}" loading="lazy"
          style="width:260px;height:120px;border:1px solid var(--axis);border-radius:4px;background:#fff"></iframe>
        <a class="uuid" href="${esc(artUrl(uuid, rel))}" target="_blank">open</a>`;
    }
    return `<tr><td>${esc(r.kind || "artifact")}</td><td>${link}</td>
      <td class="num">${fmtSize(r.size_bytes)}</td><td>${preview}</td></tr>`;
  }).join("");
  const MAX_FILES = 200;
  const fileRows = files.slice(0, MAX_FILES).map((f) =>
    `<tr><td><a class="uuid" href="${esc(artUrl(uuid, f.path))}" download>${esc(f.path)}</a></td>
     <td class="num">${fmtSize(f.size_bytes)}</td></tr>`).join("");
  return `<details class="chart" style="margin-top:14px" open>
    <summary style="cursor:pointer;font-weight:600;font-size:13px">artifacts
      <span class="sub">${files.length} file${files.length === 1 ? "" : "s"}${
        lineage.length ? ` · ${lineage.length} lineage record${lineage.length === 1 ? "" : "s"}` : ""}</span></summary>
    ${rows ? `<table style="margin-top:8px" aria-label="lineage artifacts">
      <tr><th>kind</th><th>artifact</th><th>size</th><th>preview</th></tr>${rows}</table>` : ""}
    ${fileRows ? `<div style="max-height:220px;overflow:auto;margin-top:8px">
      <table aria-label="artifact files"><tr><th>file</th><th>size</th></tr>${fileRows}</table></div>` : ""}
    ${files.length > MAX_FILES ? `<div class="sub">showing ${MAX_FILES} of ${files.length} files</div>` : ""}
  </details>`;
}

function fmtMs(ms) {
  if (ms == null) return "";
  return ms >= 1000 ? (ms / 1000).toFixed(2) + "s" : ms.toFixed(1) + "ms";
}

// Run-lifecycle waterfall over /runs/{uuid}/timeline (obs.trace):
// one bar per span (indented by tree depth, error spans red), chaos
// and retry annotations as dot markers ON the phase they hit.
function timelinePanel(tl) {
  if (!tl || !Array.isArray(tl.spans) || !tl.spans.length) return "";
  const t0 = tl.t0, total = Math.max(tl.duration_ms || 0, 1);
  const pct = (epoch) =>
    Math.max(0, Math.min(((epoch - t0) * 1000) / total * 100, 99.6));
  const rows = [];
  const walk = (s, depth) => {
    const width = Math.max((s.duration_ms || 0) / total * 100, 0.4);
    const events = (s.events || []).map((ev) => {
      const label = ev.name +
        (ev.attributes ? " " + JSON.stringify(ev.attributes) : "");
      return `<span class="tl-ev${/^chaos\\./.test(ev.name) ? " chaos" : ""}"` +
        ` style="left:${pct(ev.time).toFixed(2)}%" title="${esc(label)}"></span>`;
    }).join("");
    const title = s.name + (s.error ? " — " + s.error : "");
    rows.push(`<div class="tl-row">` +
      `<span class="tl-name" style="padding-left:${depth * 12}px"` +
      ` title="${esc(title)}">${esc(s.name)}</span>` +
      `<span class="tl-track"><span class="tl-bar${
        s.status === "error" ? " err" : ""}"` +
      ` style="left:${pct(s.start).toFixed(2)}%;width:${width.toFixed(2)}%">` +
      `</span>${events}</span>` +
      `<span class="tl-dur">${fmtMs(s.duration_ms)}</span></div>`);
    (s.children || []).forEach((c) => walk(c, depth + 1));
  };
  tl.spans.forEach((s) => walk(s, 0));
  const loose = (tl.events || []).map((ev) =>
    `<div class="tl-row"><span class="tl-name" title="${esc(ev.name)}">` +
    `* ${esc(ev.name)}</span><span class="tl-track">` +
    `<span class="tl-ev" style="left:${pct(ev.time).toFixed(2)}%"></span>` +
    `</span><span class="tl-dur">+${fmtMs((ev.time - t0) * 1000)}</span>` +
    `</div>`).join("");
  return `<div class="tl" aria-label="run lifecycle timeline">` +
    `<h3>timeline <span style="font-weight:400;color:var(--muted)">` +
    `${fmtMs(tl.duration_ms)} · ${tl.span_count} spans</span></h3>` +
    rows.join("") + loose + `</div>`;
}

function lineageGraphPanel(uuid, graph) {
  // Cross-run lineage: inputs → run → outputs as a three-column SVG
  // (upstream runs | this run + its artifact records | downstream
  // runs). Edge kinds: param ref, dag dependency, join match, cache
  // adoption. Run nodes navigate like every other chip.
  if (!graph || !graph.edges) return "";
  const ups = graph.edges.filter(e => e.to === uuid);
  const downs = graph.edges.filter(e => e.from === uuid);
  const arts = (graph.artifacts || []).slice(0, 8);
  const outs = Object.keys(graph.outputs || {}).slice(0, 8);
  if (!ups.length && !downs.length && !arts.length && !outs.length) return "";
  const byId = {};
  for (const n of graph.nodes || []) byId[n.uuid] = n;
  const ROW = 34, W = 640, COLW = 200, TOP = 26;
  // The right column stacks artifacts, outputs, AND downstream runs
  // sequentially — size for their SUM or the tail clips off the SVG.
  const rows = Math.max(
    ups.length, arts.length + outs.length + downs.length, 1);
  const H = TOP + rows * ROW + 10;
  const nodeBox = (x, y, n, edge) => {
    const name = esc((n && (n.name || n.uuid.slice(0, 8))) || "?");
    const color = n ? (STATUS[n.status] || ["var(--muted)"])[0] : "var(--muted)";
    const label = edge ? esc(edge.kind + (edge.label ? `:${edge.label}` : "")) : "";
    return `<g class="lingnode" data-uuid="${esc(n ? n.uuid : "")}" style="cursor:pointer">
      <rect x="${x}" y="${y}" width="${COLW - 24}" height="24" rx="5"
        fill="var(--surface-2, rgba(128,128,128,.12))" stroke="${color}"/>
      <text x="${x + 8}" y="${y + 16}" font-size="11" fill="currentColor">${name}</text>
      ${label ? `<text x="${x + COLW - 28}" y="${y + 16}" font-size="9" text-anchor="end" fill="var(--muted)">${label}</text>` : ""}
    </g>`;
  };
  const artBox = (x, y, label, kind) => `<g>
      <rect x="${x}" y="${y}" width="${COLW - 24}" height="24" rx="12"
        fill="none" stroke="var(--axis)" stroke-dasharray="3 2"/>
      <text x="${x + 8}" y="${y + 16}" font-size="10" fill="var(--muted)">${esc(kind)}: ${esc(label)}</text>
    </g>`;
  const midX = COLW + 20, rightX = 2 * COLW + 40;
  let svg = "";
  const midY = TOP + 4;
  // center: the run itself
  svg += `<rect x="${midX}" y="${midY}" width="${COLW - 24}" height="24" rx="5"
      fill="var(--series-1)" opacity="0.15"/>
    <rect x="${midX}" y="${midY}" width="${COLW - 24}" height="24" rx="5"
      fill="none" stroke="var(--series-1)"/>
    <text x="${midX + 8}" y="${midY + 16}" font-size="11" font-weight="600"
      fill="currentColor">${esc((byId[uuid] || {}).name || uuid.slice(0, 8))}</text>`;
  ups.forEach((e, i) => {
    const y = TOP + i * ROW;
    svg += nodeBox(10, y, byId[e.from], e);
    svg += `<line x1="${10 + COLW - 24}" y1="${y + 12}" x2="${midX}" y2="${midY + 12}"
      stroke="var(--axis)" marker-end="url(#lgarrow)"/>`;
  });
  // right column: artifacts/outputs first, then downstream runs
  let ri = 0;
  arts.forEach((a) => {
    const y = TOP + ri++ * ROW;
    svg += artBox(rightX, y, a.name || a.rel_path || "", a.kind || "artifact");
    svg += `<line x1="${midX + COLW - 24}" y1="${midY + 12}" x2="${rightX}" y2="${y + 12}"
      stroke="var(--axis)" stroke-dasharray="3 2"/>`;
  });
  outs.forEach((k) => {
    const y = TOP + ri++ * ROW;
    svg += artBox(rightX, y, k, "output");
    svg += `<line x1="${midX + COLW - 24}" y1="${midY + 12}" x2="${rightX}" y2="${y + 12}"
      stroke="var(--axis)" stroke-dasharray="3 2"/>`;
  });
  downs.forEach((e) => {
    const y = TOP + ri++ * ROW;
    svg += nodeBox(rightX, y, byId[e.to], e);
    svg += `<line x1="${midX + COLW - 24}" y1="${midY + 12}" x2="${rightX}" y2="${y + 12}"
      stroke="var(--axis)" marker-end="url(#lgarrow)"/>`;
  });
  return `<details class="chart" style="margin-top:14px" open id="lineageGraph">
    <summary style="cursor:pointer;font-weight:600;font-size:13px">lineage graph
      <span class="sub">${ups.length} upstream · ${arts.length + outs.length} artifacts/outputs · ${downs.length} downstream</span></summary>
    <svg viewBox="0 0 ${W} ${H}" role="img" aria-label="cross-run lineage graph"
         style="max-width:100%">
      <defs><marker id="lgarrow" viewBox="0 0 8 8" refX="7" refY="4"
        markerWidth="6" markerHeight="6" orient="auto">
        <path d="M0,0 L8,4 L0,8 z" fill="var(--axis)"/></marker></defs>
      <text x="10" y="14" font-size="10" fill="var(--muted)">inputs</text>
      <text x="${midX}" y="14" font-size="10" fill="var(--muted)">run</text>
      <text x="${rightX}" y="14" font-size="10" fill="var(--muted)">outputs</text>
      ${svg}
    </svg>
  </details>`;
}

const SERIES = [1, 2, 3, 4, 5, 6].map(i => `var(--series-${i})`);

function overlayChart(name, seriesList) {
  // Multi-run overlay: one line per run over a shared scale; legend
  // below the title carries the color key (marks only get color).
  const all = seriesList.flatMap(s => s.points);
  if (!all.length) return "";
  const f = chartFrame(all);
  const paths = seriesList.map((s, i) =>
    `<path d="${f.linePath(s.points)}" fill="none" stroke="${SERIES[i % SERIES.length]}"
      stroke-width="2" stroke-linejoin="round" stroke-linecap="round">
      <title>${esc(s.label)}</title></path>`).join("");
  const legend = seriesList.map((s, i) =>
    `<span class="key"><span class="swatch" style="background:${SERIES[i % SERIES.length]}"></span>${esc(s.label)}</span>`).join("");
  return `<div class="chart">
    <h3>${esc(name)}</h3>
    <div class="legend">${legend}</div>
    <svg viewBox="0 0 ${CW} ${CH}" role="img" aria-label="${esc(name)} across runs">
      ${f.grid}
      ${f.baseline}
      ${paths}
    </svg>
  </div>`;
}

async function compareRuns() {
  const sel = selectedRuns();
  const detail = $("#detail");
  const gen = ++renderGen;
  stopDetailTimers();
  const fetched = await Promise.all(sel.map(async r => ({
    ...r,
    metrics: await api(`${base()}/runs/${r.uuid}/metrics`).catch(() => ({})),
  })));
  if (gen !== renderGen) return;  // user navigated mid-fetch
  const names = [...new Set(fetched.flatMap(f => Object.keys(f.metrics)))].sort();
  const charts = names.map(name => overlayChart(
    name,
    fetched
      .map(f => ({label: f.name, points: f.metrics[name] || []}))
      .filter(s => s.points.length)
  )).join("");
  detail.innerHTML = `
    <h2 style="font-size:15px">comparing ${sel.length} runs</h2>
    ${paramDiffTable(sel)}
    <div class="charts">${charts ||
      "<div class='sub' style='color:var(--muted)'>no shared metrics yet</div>"}</div>`;
  detail.scrollIntoView({behavior: "smooth"});
}

function paramDiffTable(sel) {
  // The question a sweep comparison answers is "what was different?":
  // one row per param whose value VARIES across the selected runs
  // (op-level params + meta.trial_params), identical params omitted.
  const uuids = new Set(sel.map(r => r.uuid));
  const rows = lastRows.filter(r => uuids.has(r.uuid));
  if (rows.length < 2) return "";
  const valsOf = r => {
    const out = {};
    for (const [k, v] of Object.entries(r.params || {}))
      out[k] = (v && typeof v === "object" && "value" in v) ? v.value : v;
    Object.assign(out, (r.meta || {}).trial_params || {});
    return out;
  };
  const perRun = rows.map(r => ({
    label: r.name || String(r.uuid).slice(0, 8), vals: valsOf(r)}));
  const keys = [...new Set(perRun.flatMap(p => Object.keys(p.vals)))].sort();
  const differing = keys.filter(k => new Set(
    perRun.map(p => JSON.stringify(p.vals[k]))).size > 1);
  if (!differing.length) return "";
  const fmt = v => v === undefined ? "–"
    // Integers render EXACTLY (this table's one job is showing the
    // difference; 16384 must not display as 16380); floats get
    // 6 significant digits.
    : typeof v === "number"
      ? (Number.isInteger(v) ? String(v) : String(+v.toPrecision(6)))
      : esc(String(v));
  const head = `<tr><th>param</th>${perRun.map(p =>
    `<th>${esc(p.label)}</th>`).join("")}</tr>`;
  const body = differing.map(k => `<tr><td>${esc(k)}</td>${perRun.map(p =>
    `<td class="num">${fmt(p.vals[k])}</td>`).join("")}</tr>`).join("");
  return `<div class="bracket"><h3>differing params</h3>
    <table><thead>${head}</thead><tbody>${body}</tbody></table></div>`;
}

function fmtParams(params) {
  return Object.entries(params || {})
    .map(([k, v]) => {
      // Op-level params are stored as V1Param dicts: unwrap .value.
      if (v && typeof v === "object" && "value" in v) v = v.value;
      return `${k}=${typeof v === "number" ? +v.toPrecision(3) : v}`;
    })
    .join(" ");
}

// Outputs of terminal trials never change: cache them across the 5s
// live rerenders so an N-trial sweep costs O(live trials) per tick.
const outputsCache = new Map();  // uuid -> outputs (terminal only)

async function sweepView(run) {
  // Hyperband bracket / rung visualization: children grouped by
  // (bracket, rung) with live trial statuses and observed metric.
  const children = (await api(
    `${base()}/runs?pipeline=${encodeURIComponent(run.uuid)}`
  ).catch(() => ({results: []}))).results || [];
  if (!children.length) return "";
  const metricName = run.spec?.matrix?.metric?.name;
  const maximize = run.spec?.matrix?.metric?.optimization === "maximize";
  const outputs = await Promise.all(children.map(async c => {
    if (outputsCache.has(c.uuid)) return outputsCache.get(c.uuid);
    const out = await api(
      `${base()}/runs/${c.uuid}/outputs`).catch(() => ({}));
    if (TERMINAL.has(c.status)) outputsCache.set(c.uuid, out);
    return out;
  }));
  const trials = children.map((c, i) => {
    const out = outputs[i] || {};
    const val = metricName != null
      ? (out[`final_${metricName}`] ?? out[metricName])
      : Object.entries(out).find(([k]) => k.startsWith("final_"))?.[1];
    return {...c, metric: typeof val === "number" ? val : null};
  });
  const groups = new Map();
  for (const t of trials) {
    const b = t.meta?.bracket, r = t.meta?.rung;
    const key = b != null ? `bracket ${b} · rung ${r}` : "trials";
    if (!groups.has(key)) groups.set(key, []);
    groups.get(key).push(t);
  }
  const rows = [...groups.entries()].map(([label, ts]) => {
    // Best trial first, honoring the sweep's optimization direction.
    ts.sort((a, b) => {
      const worst = maximize ? -Infinity : Infinity;
      const av = a.metric ?? worst, bv = b.metric ?? worst;
      return maximize ? bv - av : av - bv;
    });
    const chips = ts.map(t => `
      <span class="chip" data-uuid="${esc(t.uuid)}" role="button" tabindex="0">
        ${pill(t.status)} ${esc(fmtParams(t.meta?.trial_params || t.params))}
        ${t.metric != null ? `<span class="val">${+t.metric.toPrecision(4)}</span>` : ""}
      </span>`).join("");
    return `<div class="rung"><span class="rname">${esc(label)} · ${ts.length} trials</span>${chips}</div>`;
  }).join("");
  return `<div class="bracket">
    <h3>sweep${metricName ? ` · ${maximize ? "maximizing" : "minimizing"} ${esc(metricName)}` : ""}</h3>
    ${rows}
  </div>`;
}

async function renderSlices() {
  // The C++ slice pool's operator view: per-slice chip occupancy and
  // placed gangs. Hidden entirely when no agent manages slices.
  const data = await api("/api/v1/agent/slices").catch(() => null);
  const el = $("#slicesPanel");
  if (!data || !data.slices || !data.slices.length) { el.innerHTML = ""; return; }
  const byslice = {};
  for (const g of data.gangs || [])
    (byslice[g.slice] = byslice[g.slice] || []).push(g);
  el.innerHTML = `<div class="bracket"><h3>TPU slice pool</h3>` +
    data.slices.map(s => {
      const used = s.total_chips - s.free_chips;
      const gangs = (byslice[s.name] || []).map(g =>
        `<span class="chip" data-uuid="${esc(g.run_uuid)}" role="button"
           tabindex="0">${pill(g.state)} ${esc(String(g.run_uuid).slice(0, 8))}
           · ${esc(g.topology)}${g.restarts ? ` · ↻${g.restarts}` : ""}</span>`
      ).join("");
      return `<div class="rung"><span class="rname">${esc(s.name)}
          · ${esc(s.topology)}${s.preemptible ? " · spot" : ""}</span>
        <span class="val">${used}/${s.total_chips} chips</span>${gangs}</div>`;
    }).join("") + "</div>";
  wireRunChips(el);
}

async function dagView(run) {
  // Pipeline graph: nodes from the dag spec's operations, statuses
  // from the child runs (created lazily as upstreams finish — a node
  // with no child yet renders as pending). Upstream's flow viz, lite.
  const ops = run.spec?.component?.run?.operations || [];
  if (!ops.length) return "";
  const children = (await api(
    `${base()}/runs?pipeline=${encodeURIComponent(run.uuid)}`
  ).catch(() => ({results: []}))).results || [];
  const byName = new Map(children.map(c => [c.name, c]));
  // Longest-path layering (deps are validated acyclic at submit).
  const deps = new Map(ops.map(o => [o.name, o.dependencies || []]));
  const layerOf = new Map();
  const layer = (name, seen) => {
    if (layerOf.has(name)) return layerOf.get(name);
    if (!seen) seen = new Set();
    if (seen.has(name) || !deps.has(name)) return 0;
    seen.add(name);
    const ds = deps.get(name);
    const v = ds.length ? 1 + Math.max(...ds.map(d => layer(d, seen))) : 0;
    layerOf.set(name, v);
    return v;
  };
  const W = 150, H = 40, GX = 70, GY = 18, PAD = 14;
  const cols = new Map();  // layer -> next row index
  const pos = new Map();
  for (const o of ops) {
    const l = layer(o.name);
    const row = cols.get(l) || 0;
    cols.set(l, row + 1);
    pos.set(o.name, {x: PAD + l * (W + GX), y: PAD + row * (H + GY)});
  }
  const width = PAD * 2 + (Math.max(...[...layerOf.values(), 0]) + 1) * (W + GX) - GX;
  const height = PAD * 2 + Math.max(...[...cols.values()]) * (H + GY) - GY;
  const edges = ops.flatMap(o => (deps.get(o.name) || []).map(d => {
    const a = pos.get(d), b = pos.get(o.name);
    if (!a || !b) return "";
    const x1 = a.x + W, y1 = a.y + H / 2, x2 = b.x, y2 = b.y + H / 2;
    const mx = (x1 + x2) / 2;
    return `<path class="edge" marker-end="url(#dagarrow)"
      d="M ${x1} ${y1} C ${mx} ${y1}, ${mx} ${y2}, ${x2 - 4} ${y2}"/>`;
  })).join("");
  const nodes = ops.map(o => {
    const c = byName.get(o.name);
    const status = c ? c.status : "pending";
    const [color, glyph] = STATUS[status] || ["var(--muted)", "•"];
    const p = pos.get(o.name);
    const label = o.name.length > 18 ? o.name.slice(0, 17) + "…" : o.name;
    // Only nodes with a child run are interactive: a pending node as a
    // focusable dead "button" misleads keyboard/screen-reader users.
    const act = c ? `data-uuid="${esc(c.uuid)}" role="button" tabindex="0"` : "";
    return `<g class="dagnode${c ? "" : " inert"}" ${act}
        aria-label="${esc(o.name)}: ${esc(status)}">
      <rect x="${p.x}" y="${p.y}" width="${W}" height="${H}" rx="7"
            stroke="${color}"/>
      <text x="${p.x + 10}" y="${p.y + 17}">${esc(label)}</text>
      <text class="st" x="${p.x + 10}" y="${p.y + 31}">${glyph} ${esc(status)}</text>
    </g>`;
  }).join("");
  return `<div class="bracket dag"><h3>pipeline · ${ops.length} operations</h3>
    <svg viewBox="0 0 ${width} ${height}" style="height:${Math.min(height, 420)}px"
         aria-label="pipeline graph">
      <defs><marker id="dagarrow" viewBox="0 0 8 8" refX="7" refY="4"
        markerWidth="7" markerHeight="7" orient="auto">
        <path d="M 0 0 L 8 4 L 0 8 z" fill="var(--axis)"/></marker></defs>
      ${edges}${nodes}
    </svg></div>`;
}

let detailTimer = null;
// Monotonic render generation: an in-flight fetch chain whose gen is
// stale (user navigated meanwhile) must not touch the DOM.
let renderGen = 0;
function stopDetailTimers() {
  if (detailTimer) { clearTimeout(detailTimer); detailTimer = null; }
  if (logSource) { logSource.close(); logSource = null; }
}

let logSource = null;
const TERMINAL = new Set(["succeeded", "failed", "stopped", "upstream_failed", "skipped"]);
async function showRun(uuid, opts) {
  const rerender = opts && opts.rerender;
  const detail = $("#detail");
  const gen = ++renderGen;
  stopDetailTimers();
  // Stream token BEFORE any tokenQS-built URL below (img/artifact
  // hrefs, the logs EventSource) — see ensureStreamToken.
  await ensureStreamToken();
  const [run, metrics, images, hists] = await Promise.all([
    api(`${base()}/runs/${uuid}`),
    api(`${base()}/runs/${uuid}/metrics`).catch(() => ({})),
    api(`${base()}/runs/${uuid}/events?kind=image`).catch(() => ({})),
    api(`${base()}/runs/${uuid}/events?kind=histogram`).catch(() => ({})),
  ]);
  const isSweep = run.kind === "matrix";
  const isDag = run.kind === "dag";
  const isPipeline = isSweep || isDag;
  // Artifact listing stats the whole run tree server-side — skip it
  // for pipelines (their artifacts live in child runs) so the 5 s live
  // rerender loop doesn't re-walk the tree forever.
  const [lineage, files, lingraph, timeline] = isPipeline
    ? [[], [], null, null]
    : await Promise.all([
    api(`${base()}/runs/${uuid}/lineage`).catch(() => []),
    api(`${base()}/runs/${uuid}/artifacts?detail=1`).catch(() => []),
    api(`${base()}/runs/${uuid}/lineage/graph`).catch(() => null),
    api(`${base()}/runs/${uuid}/timeline`).catch(() => null),
  ]);
  const sweep = isSweep ? await sweepView(run)
    : isDag ? await dagView(run) : "";
  if (gen !== renderGen) return;  // user navigated mid-fetch
  const charts = Object.entries(metrics)
    .filter(([, pts]) => Array.isArray(pts) && pts.length)
    .map(([name, pts]) => lineChart(name, pts)).join("");
  const media =
    Object.entries(hists).filter(([, evs]) => evs.length)
      .map(([name, evs]) => histChart(name, evs[evs.length - 1])).join("") +
    Object.entries(images).filter(([, evs]) => evs.length)
      .map(([name, evs]) => imageCard(uuid, name, evs[evs.length - 1])).join("");
  detail.innerHTML = `
    <h2 style="font-size:15px">${esc(run.name || run.uuid)} ${pill(run.status)}</h2>
    ${sweep}
    <div class="charts">${charts || (isPipeline ? "" : "<div class='sub' style='color:var(--muted)'>no metrics yet</div>")}</div>
    ${media ? `<div class="charts">${media}</div>` : ""}
    ${timelinePanel(timeline)}
    ${artifactsPanel(uuid, Array.isArray(lineage) ? lineage : [],
                     Array.isArray(files) ? files : [])}
    ${lineageGraphPanel(uuid, lingraph)}
    <div id="logs" aria-label="run logs"${isPipeline ? " hidden" : ""}></div>`;
  for (const el of detail.querySelectorAll(".chart")) wireChart(el);
  wireRunChips(detail);
  if (!isPipeline) {
    const logs = $("#logs");
    // EventSource cannot set headers; the SSE route accepts ?token=
    // (a short-lived stream token when one is minted — see tokenQS).
    logSource = new EventSource(`/streams/v1/${encodeURIComponent(OWNER)}/default/runs/${uuid}/logs?follow=true${tokenQS("&")}`);
    logSource.onmessage = (ev) => { logs.textContent += ev.data + "\n"; logs.scrollTop = logs.scrollHeight; };
    logSource.addEventListener("done", () => { logSource.close(); logSource = null; });
  } else if (!TERMINAL.has(run.status)) {
    // Live pipeline (sweep or dag): re-render while children advance.
    detailTimer = setTimeout(() => showRun(uuid, {rerender: true}), 5000);
  }
  if (!rerender) detail.scrollIntoView({behavior: "smooth"});
}

$("#refresh").onclick = loadRuns;
$("#tokenBox").onchange = () => {
  const v = $("#tokenBox").value.trim();
  // "owner:token" scopes the dashboard to that owner's paths (scoped
  // credentials are path-isolated); a bare value is the admin token.
  const sep = v.indexOf(":");
  if (sep > 0) {
    localStorage.setItem("plx_owner", v.slice(0, sep));
    localStorage.setItem("plx_token", v.slice(sep + 1));
  } else if (v) {
    localStorage.removeItem("plx_owner");
    localStorage.setItem("plx_token", v);
  } else {
    localStorage.removeItem("plx_owner");
    localStorage.removeItem("plx_token");
  }
  location.reload();  // reinitialize every surface (incl. SSE streams)
};
$("#statusFilter").onchange = loadRuns;
$("#projectFilter").onchange = loadRuns;
$("#searchBox").oninput = () => {  // debounced; no network round-trip
  clearTimeout(window._searchTimer);
  window._searchTimer = setTimeout(renderRuns, 150);
};
$("#compareBtn").onclick = compareRuns;
$("#themeToggle").onclick = () => {
  const root = document.documentElement;
  const dark = getComputedStyle(document.body).colorScheme.includes("dark");
  root.dataset.theme = dark ? "light" : "dark";
};
refreshStreamToken();  // mint eagerly so first img/SSE urls use it
loadRuns();
setInterval(loadRuns, 10000);
</script>
</body>
</html>
"""
