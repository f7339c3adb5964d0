"""HTTP serving for the port (port of ``polyaxon_tpu/serving/server.py``,
``batching="continuous"`` with ``kv="paged"``).

API (JSON over HTTP):
    GET  /healthz       → engine health (queue depth, slots, KV headroom)
    GET  /v1/models     → {"models": [name]}
    GET  /v1/stats      → engine counters
    POST /v1/generate   {"tokens": [[...]], "max_new_tokens": N,
                         "temperature": T?, "seed": S?, "top_p": P?,
                         "top_k": K?, "eos_tokens": [...]?}
                        → {"tokens": [[...]], "request_ids": [...]}

Weights come from a seeded random init, or from the latest step of a
checkpoint the port's training wrote (``--checkpoint <artifacts>/
checkpoints``). SSE streaming is not ported yet.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import torch

from polyaxon_tpu_torch.device import resolve_device
from polyaxon_tpu_torch.serving.batching import (
    ContinuousBatchingEngine,
    QueueFull,
    _family,
    validate_sampling,
)

logger = logging.getLogger(__name__)


def load_params(model: str, checkpoint: Optional[str] = None, seed: int = 0,
                *, device=None):
    """(cfg, params) for ``model`` on the device, matrices in
    ``cfg.dtype`` and norm gains in f32: the latest committed step of the
    port's checkpoint directory ``checkpoint`` (a saved train state, whose
    ``params`` are sliced out, or a bare params tree), else a random init
    from ``seed``. A checkpoint must match the model's tree and shapes.
    Orbax trees written by the JAX package are not read (ROADMAP.md)."""
    family = _family(model)
    cfg = family.CONFIGS[model]
    dev = resolve_device(device)
    if checkpoint:
        from polyaxon_tpu_torch.runtime.checkpoint import load_tree

        step, tree = load_tree(checkpoint, only="params")
        loaded = tree.get("params", tree)
        template = family.init(cfg, torch.Generator(), device="meta",
                               param_dtype=cfg.dtype)["params"]
        params = _cast_like(template, loaded, dev,
                            f"checkpoint {checkpoint} step {step}")
        logger.info("restored %s step=%s", checkpoint, step)
        return cfg, params
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = family.init(cfg, gen, device=dev,
                         param_dtype=cfg.dtype)["params"]
    return cfg, params


def _cast_like(template: dict, loaded: Any, device, what: str,
               path: str = "") -> dict:
    """``loaded`` on ``device`` in ``template``'s dtypes; raises unless
    its tree and shapes are ``template``'s."""
    if not isinstance(loaded, dict) or set(loaded) != set(template):
        got = sorted(loaded) if isinstance(loaded, dict) else type(loaded)
        raise ValueError(f"{what} does not match the model at "
                         f"'{path or '/'}': keys {got}, expected "
                         f"{sorted(template)}")
    out = {}
    for key, ref in template.items():
        value, sub = loaded[key], f"{path}/{key}"
        if isinstance(ref, dict):
            out[key] = _cast_like(ref, value, device, what, sub)
            continue
        if not isinstance(value, torch.Tensor) or value.shape != ref.shape:
            raise ValueError(f"{what}: {sub} has shape "
                             f"{getattr(value, 'shape', None)}, the model "
                             f"expects {tuple(ref.shape)}")
        out[key] = value.to(device=device, dtype=ref.dtype)
    return out


class _Handler(BaseHTTPRequestHandler):
    engine: ContinuousBatchingEngine
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
            return self._json(self.engine.health())
        if self.path == "/v1/models":
            return self._json({"models": [self.engine.model]})
        if self.path == "/v1/stats":
            return self._json(self.engine.stats())
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
            if req.get("stream"):
                raise ValueError("streaming (SSE) is not ported yet; send "
                                 "stream=false")
            max_new = int(req.get("max_new_tokens", 32))
            temperature = float(req.get("temperature", 0.0))
            seed = int(req.get("seed", 0))
            top_p = float(req.get("top_p", 1.0))
            top_k = int(req.get("top_k", 0))
            validate_sampling(top_p, top_k)
            eos_tokens = req.get("eos_tokens")
            if eos_tokens is None and "eos_token" in req:
                eos_tokens = [req["eos_token"]]
            if eos_tokens is not None and (
                    not isinstance(eos_tokens, list)
                    or not all(isinstance(t, int) and not isinstance(t, bool)
                               for t in eos_tokens)):
                raise ValueError("`eos_tokens` must be a list of token ids")
            reqs = self.engine.submit_all(
                tokens, max_new, temperature, seed, top_p, top_k,
                eos_tokens=eos_tokens)
            out = [r.wait() for r in reqs]
            return self._json({"tokens": out,
                               "request_ids": [r.id for r in reqs]})
        except QueueFull as exc:
            return self._json({"error": str(exc)}, status=503,
                              headers={"Retry-After": str(exc.retry_after)})
        except (KeyError, ValueError, TypeError) as exc:
            return self._json({"error": str(exc)}, status=400)
        except Exception as exc:  # noqa: BLE001 — the handler must answer
            logger.exception("generate failed")
            return self._json({"error": f"{type(exc).__name__}: {exc}"},
                              status=500)


class ServingServer:
    """``with ServingServer("llama_tiny", device="cpu") as s: … s.url``

    Serves one model through the paged continuous-batching engine on
    ``device`` (default ``cuda``; without a GPU and without an explicit
    ``device`` it raises)."""

    def __init__(self, model: str, checkpoint: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0, seed: int = 0,
                 batching: str = "continuous", slots: int = 4,
                 kv: str = "paged", page_size: int = 16,
                 kv_pages: Optional[int] = None, prefix_cache: bool = True,
                 max_pending: Optional[int] = None, device=None):
        if batching != "continuous":
            raise NotImplementedError(
                f"batching='{batching}': only the continuous engine is "
                "ported (ROADMAP.md, Queue 1)")
        dev = resolve_device(device)
        cfg, params = load_params(model, checkpoint, seed=seed, device=dev)
        self.engine = ContinuousBatchingEngine(
            model, cfg, params, slots=slots, kv=kv,
            page_size=page_size, kv_pages=kv_pages,
            prefix_cache=prefix_cache, max_pending=max_pending, device=dev)
        handler = type("BoundHandler", (_Handler,), {"engine": self.engine})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info("serving %s at %s", self.engine.model, self.url)
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.engine.stop()

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
