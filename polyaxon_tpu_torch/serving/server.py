"""HTTP serving for the port (port of ``polyaxon_tpu/serving/server.py``).

Two engines, as in the JAX package: the static ``_Engine`` (the default:
each batch's whole generation at once, prompts grouped by exact length,
the budget bucketed to a power of two for validation) over a dense
cache, and the continuous batcher (``batching="continuous"``,
``serving/batching.py``) over a dense or paged cache.

API (JSON over HTTP):
    GET  /healthz              → engine health (queue depth, slots, KV
                               headroom; the static engine: status)
    GET  /v1/models            → {"models": [name]}
    GET  /v1/stats             → engine counters
    GET  /v1/fleet             → per-replica telemetry (a ServingFleet
                               front end only; 404 behind one engine)
    GET  /metrics              → Prometheus text of the port's registry
    GET  /requests             → recent request summaries (continuous)
    GET  /requests/{id}        → one request's summary row
    GET  /requests/{id}/timeline → its span tree and phase summary
    GET  / and /ui             → the operator stats page
    POST /v1/generate          {"tokens": [[...]], "max_new_tokens": N,
                                "temperature": T?, "seed": S?,
                                "top_p": P?, "top_k": K?,
                                "eos_tokens": [...]?, "class": C?,
                                "stream": bool?}
                               → {"tokens": [[...]], "request_ids"?}, or
                               with stream=true an SSE stream of
                               {"index": row, "token": id} events and
                               event:done {"tokens": ...}; the continuous
                               engine streams tokens as they decode, the
                               static engine emits one burst per batch.

``GET /alerts`` evaluates the committed alert rules (``obs/rules.py``)
against this process's registry and returns the engine's state. The
llama and MoE decoders and the t5 encoder-decoder are served (t5's
prompt is the encoder input, and its generation starts from BOS).
Weights come from a seeded random init, or from the latest step of a
checkpoint in the port's store (written by the port's training, or
converted from the JAX package's Orbax format by
``scripts/convert_orbax_to_torch.py``; a LoRA fine-tune merged at
load), and may be quantized to int8 at load
(``serving/quantize.py``). With ``mesh_axes`` (``--mesh``) the weights
are sharded over a gang of processes, one card each, and rank 0's
engine runs every model call on all of them (``serving/gang.py``).
Sampled draws come from torch generators seeded by the request, so they
differ from the JAX package's; greedy output is the same.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np
import torch

from polyaxon_tpu_torch.device import resolve_device
from polyaxon_tpu_torch.serving.batching import (
    ContinuousBatchingEngine,
    QueueFull,
    _family,
    validate_sampling,
)
from polyaxon_tpu_torch.parallel.sharding import (WHOLE, ShardTaker,
                                                  require_servable,
                                                  serving_rules,
                                                  tree_placements)
from polyaxon_tpu_torch.serving.gang import ParamsRef, Worker, build_gang
from polyaxon_tpu_torch.serving.quantize import quantize_tree, tree_bytes

logger = logging.getLogger(__name__)


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def load_params(model: str, checkpoint: Optional[str] = None, seed: int = 0,
                *, device=None, quantize: Optional[str] = None,
                lora_alpha: float = 16.0, mesh=None):
    """(cfg, params) for ``model`` on the device, matrices in
    ``cfg.dtype`` and norm gains in f32: the latest committed step of the
    port's checkpoint directory ``checkpoint`` (a saved train state, whose
    ``params`` are sliced out, or a bare params tree), else a random init
    from ``seed``. A LoRA fine-tune's state (``{"base", "lora"}``) is
    folded into dense weights at load, one adapted weight at a time on
    the device, with alpha and rank from the checkpoint's ``_meta``
    (``lora_alpha`` is the fallback for a tree without one). A checkpoint
    must match the model's tree and shapes. ``quantize="int8"`` quantizes
    the matrices at load. An Orbax checkpoint of the JAX package is read
    once converted to the port's store by
    ``scripts/convert_orbax_to_torch.py`` (params only).

    With a ``mesh`` (sharded serving, ``serving/gang.py``) the params are
    this rank's pieces by the serving rules (``parallel/sharding.py
    serving_rules``, the JAX server's table): a random init draws every
    slab from the seed and keeps its piece, a checkpoint's leaves are cut
    one by one as they are read (a LoRA state is read whole and merged on
    the host first), and int8 quantizes the pieces with each channel's
    whole-weight scale."""
    family = _family(model)
    cfg = family.CONFIGS[model]
    dev = resolve_device(device)
    taker = WHOLE
    if mesh is not None:
        taker = ShardTaker(family.logical_axes(cfg)["params"], mesh,
                           serving_rules(mesh))
    if checkpoint:
        from polyaxon_tpu_torch.runtime.checkpoint import load_tree

        template = family.init(cfg, torch.Generator(), device="meta",
                               param_dtype=cfg.dtype)["params"]

        def cut(path: str, value):
            """A leaf of the model's tree cut to this rank's piece as it
            is read (a LoRA state's leaves stay whole: merged below)."""
            keys = tuple(path.split("/"))[1 if path.startswith("params/")
                                          else 0:]
            ref = template
            for key in keys:
                ref = ref.get(key) if isinstance(ref, dict) else None
            if isinstance(ref, dict) or ref is None or \
                    getattr(value, "shape", None) != ref.shape:
                return value  # not this model's leaf: _cast_like names it
            return taker.whole(keys, value)

        step, tree = load_tree(checkpoint, only="params",
                               **({} if mesh is None else {"take": cut}))
        loaded = tree.get("params", tree)
        if isinstance(loaded, dict) and set(loaded) == {"base", "lora"}:
            from polyaxon_tpu_torch.models.lora import merge_saved

            loaded = merge_saved(loaded["base"], loaded["lora"],
                                 alpha=lora_alpha,
                                 device=dev if mesh is None else "cpu",
                                 dtype=cfg.dtype)
            logger.info("merged LoRA adapters into %s", model)
        params = _cast_like(template, loaded, dev,
                            f"checkpoint {checkpoint} step {step}",
                            take=taker)
        logger.info("restored %s step=%s", checkpoint, step)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if getattr(family.model_def(model), "sharded_init", False):
            params = family.init(cfg, gen, device=dev, param_dtype=cfg.dtype,
                                 take=taker)["params"]
        else:
            params = taker.tree(family.init(
                cfg, gen, device=dev, param_dtype=cfg.dtype)["params"])
    if quantize:
        full = tree_bytes(params)
        params = quantize_tree(
            params, mode=quantize,
            groups=lambda path, dim: [mesh.group(a)
                                      for a in taker.axes(path, dim)])
        logger.info("quantized %s weights %s: %.1f MiB -> %.1f MiB", model,
                    quantize, full / 2**20, tree_bytes(params) / 2**20)
    return cfg, params


def _cast_like(template: dict, loaded: Any, device, what: str,
               path: str = "", take: ShardTaker = WHOLE) -> dict:
    """``loaded`` on ``device`` in ``template``'s dtypes, each leaf this
    rank's piece by ``take`` (cut here, or already as it was read);
    raises unless its tree and shapes are ``template``'s."""
    if not isinstance(loaded, dict) or set(loaded) != set(template):
        got = sorted(loaded) if isinstance(loaded, dict) else type(loaded)
        raise ValueError(f"{what} does not match the model at "
                         f"'{path or '/'}': keys {got}, expected "
                         f"{sorted(template)}")
    out = {}
    for key, ref in template.items():
        value, sub = loaded[key], f"{path}/{key}"
        if isinstance(ref, dict):
            out[key] = _cast_like(ref, value, device, what, sub, take)
            continue
        keys = tuple(sub.strip("/").split("/"))
        piece = take.leaf(keys, ref.shape).shape
        if not isinstance(value, torch.Tensor) or value.shape not in (
                ref.shape, piece):
            raise ValueError(f"{what}: {sub} has shape "
                             f"{getattr(value, 'shape', None)}, the model "
                             f"expects {tuple(ref.shape)}")
        if value.shape != piece:
            value = take.whole(keys, value)
        out[key] = value.to(device=device, dtype=ref.dtype)
    return out


class _Engine:
    """Whole-generation engine around the family's ``generate``: one
    prefill and one decode loop per group of rows of equal prompt length
    (padding a causal prompt would change what its tokens attend to).

    ``draft``: optional ``(draft_model, draft_cfg, draft_params, k)``
    enables speculative decoding for greedy requests (lossless: the
    output is the target's own greedy sequence). Sampled requests and
    requests without cache headroom for the k+1 verify window take the
    plain path.

    The JAX engine runs the whole bucketed budget as one compiled program
    and truncates; with no program to share, this one generates
    ``max_new_tokens`` (the same tokens). Budgets are still validated
    against the bucket, so both engines accept and refuse alike."""

    def __init__(self, model: str, cfg, params, draft=None, device=None,
                 gang=None):
        self.model = model
        self.cfg = cfg
        self.params = params
        self.draft = draft
        self.device = resolve_device(device)
        self._served = 0
        self._tokens_out = 0
        self._lock = threading.Lock()  # one generation on the card at a time
        # Under a serving gang every model call runs on every rank
        # (``serving/gang.py``); ``params`` is then its marker.
        self._family_mod = _family(model)
        if gang is not None:
            self._family_mod = gang.family("target", self._family_mod)
        self._family_mod.check_kernel_shapes(cfg, self.device, paged=False)
        # A seq2seq family's prompt is the encoder input and it decodes
        # into its own cache, so prompt and budget are bounded apart.
        self.seq2seq = bool(getattr(self._family_mod, "SEQ2SEQ", False))
        if draft is not None:
            if not hasattr(self._family_mod, "decode_chunk"):
                raise ValueError(
                    f"speculative decoding needs the target family to "
                    f"expose decode_chunk; `{model}` does not — serve "
                    "without --draft-model")
            if getattr(cfg, "sliding_window", None) is not None:
                raise ValueError(
                    "speculative decoding requires a full-length cache "
                    "(no sliding_window)")
            self._draft_family = _family(draft[0])
            if gang is not None:
                self._draft_family = gang.family("draft",
                                                 self._draft_family)
            missing = [name for name in ("prefill", "decode_step_ragged")
                       if not hasattr(self._draft_family, name)]
            if missing:
                raise ValueError(
                    f"draft `{draft[0]}` cannot speculate: its family "
                    f"lacks {missing}")
            self._draft_family.check_kernel_shapes(draft[1], self.device,
                                                   paged=False)

    def _spec_usable(self, plen: int, n_bucket: int) -> bool:
        if self.draft is None:
            return False
        _, draft_cfg, _, spec_k = self.draft
        need = plen + n_bucket + spec_k + 1
        return (need <= self.cfg.max_seq_len
                and need <= draft_cfg.max_seq_len)

    def _validate(self, tokens: list[int], max_new_tokens: int) -> None:
        """Request-level checks, shared with the streaming handler so a
        bad request is rejected before any work (or any SSE header)."""
        if len(tokens) < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        plen, n_bucket = len(tokens), _bucket(max_new_tokens, lo=16)
        if self.seq2seq:
            if max(plen, n_bucket) > self.cfg.max_seq_len:
                raise ValueError(
                    f"prompt {plen} or generation budget {n_bucket} "
                    f"exceeds max_seq_len {self.cfg.max_seq_len}")
        elif plen + n_bucket > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt {plen} + generation budget {n_bucket} exceeds "
                f"max_seq_len {self.cfg.max_seq_len}")

    def _run(self, batch: torch.Tensor, max_new: int, spec: bool,
             temperature: float, seed: int, top_p: float,
             top_k: int) -> np.ndarray:
        if spec:
            from polyaxon_tpu_torch.serving.speculative import (
                generate_speculative,
            )

            _, draft_cfg, draft_params, spec_k = self.draft
            out = generate_speculative(
                self.cfg, self.params, draft_cfg, draft_params, batch,
                max_new_tokens=max_new, k=spec_k, family=self._family_mod,
                draft_family=self._draft_family)
        else:
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
            out = self._family_mod.generate(
                self.cfg, self.params, batch, max_new_tokens=max_new,
                temperature=temperature, top_p=top_p, top_k=top_k,
                generator=gen)
        return out.cpu().numpy()

    def generate(self, token_rows: list[list[int]], max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 top_p: float = 1.0, top_k: int = 0,
                 eos_tokens=None) -> list[list[int]]:
        if not token_rows:
            return []
        eos = frozenset(int(t) for t in (eos_tokens or ()))
        # Validate every row before running any.
        for row in token_rows:
            self._validate(row, max_new_tokens)
        validate_sampling(top_p, top_k)
        sampling = temperature > 0
        n_bucket = _bucket(max_new_tokens, lo=16)
        groups: dict[int, list[int]] = {}
        for i, row in enumerate(token_rows):
            groups.setdefault(len(row), []).append(i)
        results: list[Optional[list[int]]] = [None] * len(token_rows)
        for plen, idxs in groups.items():
            batch = torch.tensor([token_rows[i] for i in idxs],
                                 dtype=torch.long, device=self.device)
            spec = not sampling and self._spec_usable(plen, n_bucket)
            with self._lock, torch.no_grad():
                out = self._run(batch, max_new_tokens, spec, temperature,
                                seed, top_p, top_k)
            for j, i in enumerate(idxs):
                row_out = out[j, :max_new_tokens].tolist()
                if eos:
                    # Stop at the first eos (inclusive), as the
                    # continuous engine's early retire does.
                    hit = next((jj for jj, tok in enumerate(row_out)
                                if tok in eos), None)
                    if hit is not None:
                        row_out = row_out[:hit + 1]
                results[i] = row_out
        with self._lock:  # ThreadingHTTPServer: += on ints is not atomic
            self._served += len(token_rows)
            self._tokens_out += sum(
                len(r) for r in results if r is not None)
        return results  # type: ignore[return-value]

    def stats(self) -> dict:
        """Live engine counters for /v1/stats."""
        return {
            "engine": "static",
            "device": str(self.device),
            "requests_served": self._served,
            "tokens_generated": self._tokens_out,
        }


STATS_PAGE = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>polyaxon_tpu_torch — serving</title>
<style>
  :root {
    color-scheme: light dark;
    --page: #f9f9f7; --surface: #fcfcfb;
    --ink: #0b0b0b; --ink-2: #52514e; --muted: #898781;
    --ring: rgba(11,11,11,0.10); --good: #0ca30c; --bad: #d03b3b;
  }
  @media (prefers-color-scheme: dark) {
    :root { --page: #0d0d0d; --surface: #1a1a19; --ink: #fff;
            --ink-2: #c3c2b7; --ring: rgba(255,255,255,0.10); }
  }
  body { margin: 0; background: var(--page); color: var(--ink);
         font: 14px/1.45 system-ui, sans-serif; }
  header { padding: 14px 20px; border-bottom: 1px solid var(--ring);
           display: flex; gap: 10px; align-items: baseline; }
  h1 { font-size: 16px; margin: 0; font-weight: 650; }
  #state { color: var(--ink-2); font-size: 12px; }
  main { padding: 16px 20px; max-width: 900px; margin: 0 auto;
         display: flex; gap: 12px; flex-wrap: wrap; }
  .tile { background: var(--surface); border: 1px solid var(--ring);
          border-radius: 8px; padding: 10px 16px; min-width: 130px; }
  .tile .v { font-size: 22px; font-weight: 650;
             font-variant-numeric: tabular-nums; }
  .tile .k { color: var(--ink-2); font-size: 12px; }
</style>
</head>
<body>
<header><h1>polyaxon_tpu_torch serving</h1><span id="state">…</span></header>
<main id="tiles"></main>
<script>
"use strict";
const esc = (s) => String(s ?? "").replace(/[&<>"']/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
function tile(k, v) {
  return `<div class="tile"><div class="v">${esc(v)}</div>` +
         `<div class="k">${esc(k)}</div></div>`;
}
let lastTokens = null, lastT = null;
async function refresh() {
  let s;
  try { s = await (await fetch("/v1/stats")).json(); }
  catch (e) {
    document.getElementById("state").textContent = "unreachable";
    return;
  }
  let fleet = null;
  try {
    const fr = await fetch("/v1/fleet");
    if (fr.ok) fleet = await fr.json();
  } catch (e) { /* single-engine server: no fleet surface */ }
  const now = performance.now();
  let rate = "";
  if (lastTokens != null && s.tokens_generated >= lastTokens && now > lastT) {
    rate = ((s.tokens_generated - lastTokens) / ((now - lastT) / 1000))
      .toFixed(1);
  }
  lastTokens = s.tokens_generated; lastT = now;
  document.getElementById("state").textContent =
    `engine ${s.engine}` + (s.kv ? ` · kv ${s.kv}` : "") +
    (s.stopped ? " · ✕ stopped" : " · ✓ live");
  const tiles = [
    tile("requests served", s.requests_served),
    tile("tokens generated", s.tokens_generated),
    rate !== "" ? tile("tokens/sec (page-window)", rate) : "",
    s.slots != null ? tile("slots active", `${s.active} / ${s.slots}`) : "",
    s.avg_occupancy != null ? tile("avg occupancy", s.avg_occupancy) : "",
    s.queued != null ? tile("queued", s.queued) : "",
    s.decode_steps != null ? tile("decode steps", s.decode_steps) : "",
    s.step_failures ? tile("step failures", s.step_failures) : "",
    s.rejected && Object.keys(s.rejected).length
      ? tile("rejected (shed)", Object.values(s.rejected)
          .reduce((a, b) => a + b, 0)) : "",
    s.traced_requests != null
      ? tile("traced requests", s.traced_requests) : "",
    s.kv_pages_total != null
      ? tile("kv pages free", `${s.kv_pages_free} / ${s.kv_pages_total}`) : "",
    s.kv_prefix_hits != null
      ? tile("prefix hit rate", (s.kv_prefix_hits + s.kv_prefix_misses)
          ? (s.kv_prefix_hits / (s.kv_prefix_hits + s.kv_prefix_misses))
              .toFixed(2)
          : "–") : "",
    s.prefill_tokens_skipped != null
      ? tile("prefill tokens cached",
          `${s.prefill_tokens_skipped} / ${s.prefill_tokens_total}`) : "",
    s.kv_radix != null
      ? tile("radix pages (ref/resident)",
          `${s.kv_radix.referenced} / ${s.kv_radix.resident}`) : "",
  ];
  if (fleet && fleet.per_replica) {
    for (const [rid, t] of Object.entries(fleet.per_replica)) {
      tiles.push(tile(`${rid} · ttft p50/p99 ms`,
        `${t.ttft_p50_ms ?? "–"} / ${t.ttft_p99_ms ?? "–"}`));
      if (t.preemptions)
        tiles.push(tile(`${rid} · preemptions`, t.preemptions));
    }
    if (fleet.ttft_skew != null)
      tiles.push(tile("ttft skew (max/median p99)",
        Number(fleet.ttft_skew).toFixed(2)));
  }
  document.getElementById("tiles").innerHTML = tiles.join("");
}
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""


class _Handler(BaseHTTPRequestHandler):
    engine: _Engine
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _json(self, payload: Any, status: int = 200,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            # The continuous engine reports queue depth + slot
            # occupancy; the static engine has no queue to report.
            if hasattr(self.engine, "health"):
                return self._json(self.engine.health())
            return self._json({"status": "ok", "model": self.engine.model})
        if self.path == "/metrics":
            # Prometheus scrape backed by the unified registry
            # (obs.metrics): the full serving SLO schema (TTFT/TPOT/
            # queue-wait, shed-load and admission counters, engine-tick
            # gauges) is pre-registered so scrapers see every family
            # before traffic lands, plus whatever else this process
            # recorded.
            from polyaxon_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.ensure_serving_metrics()
            body = obs_metrics.REGISTRY.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/alerts":
            # The serving process evaluates the same committed ruleset
            # (obs.rules) against ITS registry — the request-p99 and
            # queue-saturation rules live where those series do.
            from polyaxon_tpu_torch.obs import rules as obs_rules

            alert_engine = obs_rules.default_engine()
            alert_engine.evaluate()
            return self._json(alert_engine.to_json())
        if self.path == "/v1/models":
            return self._json({"models": [self.engine.model]})
        if self.path == "/v1/stats":
            return self._json(self.engine.stats())
        if self.path == "/v1/fleet":
            # Fleet telemetry: aggregate stats plus the
            # per-replica breakdown read from the component-scoped
            # series. Only a ServingFleet front end carries it; a
            # single engine 404s and the stats page silently skips.
            if not hasattr(self.engine, "fleet_snapshot"):
                return self._json(
                    {"error": "fleet telemetry requires a "
                              "ServingFleet front end"}, status=404)
            return self._json(self.engine.fleet_snapshot())
        if self.path == "/requests":
            # Ring summaries, most recent first. Only the continuous
            # engine traces requests; the static engine 404s rather
            # than pretending an empty ring is a real answer.
            if not hasattr(self.engine, "recent_requests"):
                return self._json(
                    {"error": "request timelines require "
                              "--batching continuous"}, status=404)
            return self._json({"requests": self.engine.recent_requests()})
        m = re.match(r"^/requests/([0-9a-f]{1,64})/timeline$", self.path)
        if m is not None:
            if not hasattr(self.engine, "request_timeline"):
                return self._json(
                    {"error": "request timelines require "
                              "--batching continuous"}, status=404)
            timeline = self.engine.request_timeline(m.group(1))
            if timeline is None:
                return self._json(
                    {"error": f"unknown or evicted request "
                              f"`{m.group(1)}` (the trace ring keeps "
                              "the most recent requests only)"},
                    status=404)
            from polyaxon_tpu_torch.obs.analyze import request_phases

            # Phase decomposition (queue-wait/prefill/decode ms, TTFT,
            # tokens) rides along so `plx ops request-timeline` and
            # humans with curl both get the numbers without walking
            # the span tree themselves.
            timeline["summary"] = request_phases(timeline)
            return self._json(timeline)
        m = re.match(r"^/requests/([0-9a-f]{1,64})$", self.path)
        if m is not None:
            # One request's summary row. Behind a fleet front end the
            # lookup fans out over every replica's ring and the row
            # carries the serving replica's id.
            if not hasattr(self.engine, "recent_requests"):
                return self._json(
                    {"error": "request timelines require "
                              "--batching continuous"}, status=404)
            rows = [r for r in self.engine.recent_requests()
                    if r.get("request_id") == m.group(1)]
            if not rows:
                return self._json(
                    {"error": f"unknown or evicted request "
                              f"`{m.group(1)}` (the trace ring keeps "
                              "the most recent requests only)"},
                    status=404)
            return self._json(rows[0])
        if self.path in ("/", "/ui"):
            body = STATS_PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        return self._json({"error": f"no route {self.path}"}, status=404)

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/generate":
            return self._json({"error": f"no route {self.path}"}, status=404)
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(length).decode() or "{}")
            tokens = req["tokens"]
            if (not isinstance(tokens, list)
                    or not all(isinstance(r, list) and r for r in tokens)):
                raise ValueError("`tokens` must be a non-empty list of "
                                 "non-empty token-id lists")
            max_new = int(req.get("max_new_tokens", 32))
            temperature = float(req.get("temperature", 0.0))
            seed = int(req.get("seed", 0))
            top_p = float(req.get("top_p", 1.0))
            top_k = int(req.get("top_k", 0))
            validate_sampling(top_p, top_k)
            eos_tokens = req.get("eos_tokens")
            if eos_tokens is None and "eos_token" in req:
                eos_tokens = [req["eos_token"]]
            if eos_tokens is not None:
                if (not isinstance(eos_tokens, list)
                        or not all(isinstance(t, int)
                                   and not isinstance(t, bool)
                                   for t in eos_tokens)):
                    raise ValueError(
                        "`eos_tokens` must be a list of token ids")
            # Request class picks the admission queue (`interactive` /
            # `batch` / `best-effort` — unknown labels fold to `batch`,
            # no minted priority) and labels the per-class SLO
            # histograms. Bounded so a client can't mint unbounded
            # label cardinality.
            klass = req.get("class", "batch")
            if (not isinstance(klass, str) or not klass
                    or len(klass) > 64):
                raise ValueError(
                    "`class` must be a non-empty string of at most "
                    "64 chars")
            if req.get("stream"):
                return self._stream_generate(tokens, max_new, temperature,
                                             seed, top_p, top_k,
                                             eos_tokens=eos_tokens,
                                             klass=klass)
            if hasattr(self.engine, "submit_all"):
                # Continuous engine: keep the request handles so the
                # response carries ids the caller can feed straight to
                # GET /requests/{id}/timeline.
                reqs = self.engine.submit_all(
                    tokens, max_new, temperature, seed, top_p, top_k,
                    eos_tokens=eos_tokens, klass=klass)
                out = [r.wait() for r in reqs]
                return self._json({"tokens": out,
                                   "request_ids": [r.id for r in reqs]})
            out = self.engine.generate(
                tokens, max_new_tokens=max_new,
                temperature=temperature, seed=seed,
                top_p=top_p, top_k=top_k, eos_tokens=eos_tokens)
            return self._json({"tokens": out})
        except QueueFull as exc:
            # Saturated: shed load honestly instead of queueing work
            # the client will have abandoned by decode time.
            return self._json({"error": str(exc)}, status=503,
                              headers={"Retry-After": str(exc.retry_after)})
        except (KeyError, ValueError, TypeError) as exc:
            return self._json({"error": str(exc)}, status=400)
        except Exception as exc:  # noqa: BLE001 — the handler must answer
            logger.exception("generate failed")
            return self._json({"error": f"{type(exc).__name__}: {exc}"},
                              status=500)

    def _sse(self, payload: Any, event: Optional[str] = None) -> None:
        msg = ""
        if event:
            msg += f"event: {event}\n"
        msg += f"data: {json.dumps(payload)}\n\n"
        self.wfile.write(msg.encode())
        self.wfile.flush()

    def _stream_generate(self, token_rows, max_new: int, temperature: float,
                         seed: int, top_p: float = 1.0,
                         top_k: int = 0, eos_tokens=None,
                         klass: str = "batch") -> None:
        """SSE token streaming. With the continuous engine, per-token
        events flow as rows decode (the handler polls each request's
        growing output — appends are GIL-atomic); the static engine
        emits the whole batch as a burst after its compiled run."""
        # Validate before any header goes out, so bad requests are real
        # HTTP 400s (the caller catches ValueError) rather than error
        # events on an already-open stream. Both engines expose
        # _validate.
        for row in token_rows:
            self.engine._validate(row, max_new)

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        reqs = []
        try:
            if hasattr(self.engine, "submit_all"):
                reqs = self.engine.submit_all(
                    token_rows, max_new, temperature, seed, top_p, top_k,
                    eos_tokens=eos_tokens, klass=klass)
                emitted = [0] * len(reqs)
                while True:
                    progressed = False
                    for i, r in enumerate(reqs):
                        while emitted[i] < len(r.out):
                            self._sse({"index": i,
                                       "token": r.out[emitted[i]]})
                            emitted[i] += 1
                            progressed = True
                    if all(r.done.is_set() and emitted[i] == len(r.out)
                           for i, r in enumerate(reqs)):
                        break
                    if not progressed:
                        time.sleep(0.02)
                failed = [r.error for r in reqs if r.error]
                if failed:
                    return self._sse({"error": failed[0]}, event="error")
                out = [r.out for r in reqs]
                return self._sse(
                    {"tokens": out,
                     "request_ids": [r.id for r in reqs]}, event="done")
            out = self.engine.generate(
                token_rows, max_new_tokens=max_new,
                temperature=temperature, seed=seed,
                top_p=top_p, top_k=top_k, eos_tokens=eos_tokens)
            for i, row in enumerate(out):
                for tok in row:
                    self._sse({"index": i, "token": tok})
            self._sse({"tokens": out}, event="done")
        except (BrokenPipeError, ConnectionResetError):
            # Client went away mid-stream: stop burning slots on output
            # nobody will read (same invariant as generate()'s timeout
            # cancellation).
            for r in reqs:
                if not r.done.is_set():
                    self.engine.cancel(r)
        except Exception as exc:  # noqa: BLE001 — headers already sent
            try:
                self._sse({"error": f"{type(exc).__name__}: {exc}"},
                          event="error")
            except OSError:
                pass



def serving_mesh(mesh_axes: dict, device):
    """The mesh of a sharded server over every rank of the process group
    (started from the bootstrap's env contract when there is none): the
    axes in the JAX package's order, -1 absorbing the ranks the others
    leave; the product must be the group's size."""
    from polyaxon_tpu_torch.parallel import bootstrap
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, canonical_axes
    from polyaxon_tpu_torch.polyflow.runs import V1MeshSpec

    require_servable(canonical_axes(dict(mesh_axes)))
    started = not torch.distributed.is_initialized()
    bootstrap.initialize(device=device)
    try:
        mesh = build_mesh(V1MeshSpec(axes=dict(mesh_axes)),
                          device_type=torch.device(device).type)
    except ValueError:
        if started:  # leave no group behind a refused mesh
            bootstrap.shutdown()
        raise
    mesh.device_mesh()   # every rank builds the axes' groups here, alike
    logger.info("sharded serving over mesh %s (rank %d of %d)", mesh.shape,
                bootstrap.rank(), mesh.size)
    return mesh


def _view(model: str, cfg, params, mesh):
    """A rank's view of its params for ``serving/gang.py``'s ``Worker``:
    the tree as it is without a mesh, else built at each call
    (``parallel/fsdp.py serving_view``: fsdp shards gathered at use)."""
    if mesh is None:
        return lambda: params
    from polyaxon_tpu_torch.parallel.fsdp import serving_view

    family = _family(model)
    model_def = family.model_def(model)
    placements = tree_placements(family.logical_axes(cfg)["params"], mesh,
                                 serving_rules(mesh))
    return lambda: serving_view(model_def, params, placements, mesh)


class ServingServer:
    """``with ServingServer("llama_tiny", device="cpu") as s: … s.url``

    ``batching="static"`` (the default) serves through ``_Engine``;
    ``batching="continuous"`` through the slot-pool batcher, over a
    dense (the default) or paged (``kv="paged"``) cache. Runs on
    ``device`` (default ``cuda``; without a GPU and without an explicit
    ``device`` it raises).

    ``mesh_axes`` (e.g. ``{"tp": 2}``, ``{"fsdp": -1}``: -1 absorbs the
    ranks the other axes leave) shards the weights (and the draft's)
    over a mesh of every rank of the process group, one card each
    (``serving/gang.py``): every rank constructs the server alike; rank
    0 (``is_leader``) binds the port and runs the engine, the others
    call ``follow()``, which returns when rank 0 stops. dp, fsdp and tp
    are served; another axis above 1 raises (ROADMAP.md, Queue 1 item
    7d, second half). Without a process group one is started from the
    bootstrap's env contract."""

    def __init__(self, model: str, checkpoint: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0, seed: int = 0,
                 batching: str = "static", slots: int = 4,
                 mesh_axes: Optional[dict] = None,
                 quantize: Optional[str] = None, kv: str = "dense",
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 draft_model: Optional[str] = None,
                 draft_checkpoint: Optional[str] = None, spec_k: int = 4,
                 lora_alpha: float = 16.0,
                 prefill_chunk: Optional[int] = None,
                 prefill_slots: Optional[int] = None,
                 prefill_lane_budget: int = 1,
                 decode_lane_budget: int = 1,
                 max_pending: Optional[int] = None,
                 class_admission: bool = True,
                 class_max_pending: Optional[dict] = None,
                 preemption: bool = True,
                 request_tracing: bool = True,
                 trace_dump_path: Optional[str] = None,
                 device=None):
        if batching not in ("static", "continuous"):
            raise ValueError(
                f"unknown batching mode `{batching}` "
                "(expected 'static' or 'continuous')")
        if batching == "static":
            if prefill_chunk is not None:
                raise ValueError(
                    "--prefill-chunk requires --batching continuous "
                    "(the static engine runs whole generations)")
            if prefill_slots is not None:
                raise ValueError(
                    "--prefill-slots requires --batching continuous "
                    "with kv='paged' (the disaggregated lane scheduler "
                    "lives in the continuous engine)")
            if max_pending is not None:
                raise ValueError(
                    "--max-pending requires --batching continuous (the "
                    "static engine has no pending queue to bound)")
            if class_max_pending:
                raise ValueError(
                    "--class-max-pending requires --batching continuous "
                    "(the static engine has no pending queue to bound)")
            if kv != "dense":
                raise ValueError(
                    "kv='paged' requires --batching continuous (the "
                    "static engine runs whole generations, not pooled "
                    "steps)")
        dev = resolve_device(device)
        self.mesh = serving_mesh(mesh_axes, dev) if mesh_axes else None
        cfg, params = load_params(model, checkpoint, seed=seed, device=dev,
                                  quantize=quantize, lora_alpha=lora_alpha,
                                  mesh=self.mesh)
        worker = Worker()
        worker.add("target", _family(model), cfg, params,
                   _view(model, cfg, params, self.mesh))
        draft = None
        if draft_model is not None:
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            # Validate the pairing from the config before materializing
            # a single draft weight.
            draft_vocab = _family(draft_model).CONFIGS[draft_model].vocab_size
            if draft_vocab != cfg.vocab_size:
                raise ValueError(
                    f"draft `{draft_model}` (vocab {draft_vocab}) "
                    f"and target `{model}` (vocab {cfg.vocab_size}) must "
                    "share a token space — mismatched drafts propose "
                    "garbage and silently collapse acceptance")
            draft_cfg, draft_params = load_params(
                draft_model, draft_checkpoint, seed=seed, device=dev,
                quantize=quantize, mesh=self.mesh)
            worker.add("draft", _family(draft_model), draft_cfg,
                       draft_params, _view(draft_model, draft_cfg,
                                           draft_params, self.mesh))
            draft = (draft_model, draft_cfg, draft_params, spec_k)
            logger.info("speculative decoding: draft=%s k=%d",
                        draft_model, spec_k)
        self.gang = build_gang(self.mesh, worker, dev)
        self.is_leader = self.gang is None or self.gang.rank == 0
        if self.gang is not None:
            # The engine holds markers: each rank runs every model call
            # on its own shards.
            params = ParamsRef("target")
            if draft is not None:
                draft = (draft[0], draft[1], ParamsRef("draft"), draft[3])
            if not self.is_leader:
                self.engine = None
                self.httpd = None
                self._thread = None
                return
        if batching == "continuous":
            self.engine = ContinuousBatchingEngine(
                model, cfg, params, slots=slots, kv=kv,
                page_size=page_size, kv_pages=kv_pages,
                prefix_cache=prefix_cache, draft=draft,
                prefill_chunk=prefill_chunk,
                prefill_slots=prefill_slots,
                prefill_lane_budget=prefill_lane_budget,
                decode_lane_budget=decode_lane_budget,
                max_pending=max_pending,
                class_admission=class_admission,
                class_max_pending=class_max_pending,
                preemption=preemption,
                request_tracing=request_tracing,
                trace_dump_path=trace_dump_path, device=dev,
                gang=self.gang)
        else:
            self.engine = _Engine(model, cfg, params, draft=draft,
                                  device=dev, gang=self.gang)
        handler = type("BoundHandler", (_Handler,), {"engine": self.engine})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def follow(self) -> None:
        """On a rank of a gang but rank 0: run rank 0's model calls until
        it stops the server."""
        if self.is_leader:
            raise RuntimeError("rank 0 serves; follow() is for the others")
        self.gang.follow()

    def start(self) -> "ServingServer":
        if not self.is_leader:
            return self
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info("serving %s at %s", self.engine.model, self.url)
        return self

    def stop(self) -> None:
        if not self.is_leader:
            return
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            # Drain the serve loop so in-flight handlers finish before
            # the engine (their backend) is stopped underneath them.
            self._thread.join(timeout=5)
            self._thread = None
        if hasattr(self.engine, "stop"):
            self.engine.stop()
        if self.gang is not None:
            self.gang.stop()

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
