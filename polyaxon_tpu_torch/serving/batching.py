"""Continuous batching over a paged KV pool (port of
``polyaxon_tpu/serving/batching.py``, ``kv="paged"``).

A fixed pool of decode **slots** advances every live request one token
per loop iteration (``decode_step_paged``, each slot at its own depth),
and queued requests are admitted into freed slots between iterations.
Admission matches the prompt against the radix prefix cache
(``serving/paged.py``): matched pages are adopted, a mid-page divergence
is forked copy-on-write once on device, and only the novel suffix is
prefilled (bucketed to a power of two). Greedy, temperature and
top-p/top-k rows share one step; only ``[slots]`` token ids cross to the
host per iteration.

The KV pool lives on the engine's device and is updated in place. Not
ported yet: ``kv="dense"`` (refused with NotImplementedError), chunked
prefill, prefill lanes, draft/speculation, class admission and
preemption, request traces and the metrics registry (the engine takes
no parameter for them, so asking for one is a TypeError). On a CUDA
device a config whose head_dim the kernels do not take is refused at
construction.
"""

from __future__ import annotations

import collections
import logging
import statistics
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from polyaxon_tpu_torch.device import resolve_device
from polyaxon_tpu_torch.models import llama
from polyaxon_tpu_torch.models.common import sample_row
from polyaxon_tpu_torch.serving.paged import PagePool

logger = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """The engine's pending queue is at its cap: the caller should shed
    load (HTTP 503 + Retry-After)."""

    def __init__(self, message: str, retry_after: int = 1):
        super().__init__(message)
        self.retry_after = max(int(retry_after), 1)


def bucket_suffix_len(n: int, floor: int = 8) -> int:
    """Padded length for a radix-suffix prefill of ``n`` novel tokens:
    the next power of two, floored at ``floor``. The padded tail is
    routed to the scratch page at insert (``paged_insert_suffix``)."""
    if n < 1:
        raise ValueError(f"suffix length must be >= 1, got {n}")
    return max(floor, 1 << (n - 1).bit_length())


def validate_sampling(top_p: float, top_k: int) -> None:
    """Out-of-range sampling knobs raise instead of degenerating."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")


def _family(model: str):
    """The model family module serving ``model`` (llama decoders)."""
    if model in llama.CONFIGS:
        return llama
    raise ValueError(f"model `{model}` is not servable by the port; "
                     f"decoders: {sorted(llama.CONFIGS)}")


@dataclass
class _Request:
    tokens: list[int]
    max_new: int
    temperature: float
    seed: int
    top_p: float = 1.0
    top_k: int = 0
    # Generation retires at the first of these ids (included in out).
    eos: frozenset = frozenset()
    out: list[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[str] = None
    cancelled: bool = False
    submitted_at: float = field(default_factory=time.time)
    id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
    # Times a younger request was admitted past this one (the bound on
    # starvation by the cache-affinity scan).
    admit_skips: int = 0
    prefix_cached_tokens: int = 0

    def wait(self, timeout: Optional[float] = None) -> list[int]:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error:
            raise RuntimeError(self.error)
        return self.out


class ContinuousBatchingEngine:
    """Slot-pool generation engine: ``generate(rows, max_new_tokens,
    temperature, seed)`` blocks; ``submit()`` returns a waitable request
    (each HTTP thread uses it)."""

    def __init__(self, model: str, cfg, params, *, slots: int = 4,
                 max_len: Optional[int] = None, kv: str = "paged",
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 max_pending: Optional[int] = None, device=None):
        if kv == "dense":
            raise NotImplementedError(
                "kv='dense': not ported to polyaxon_tpu_torch yet "
                "(ROADMAP.md, Queue 1); this engine serves kv='paged'")
        if kv != "paged":
            raise ValueError(f"unknown kv mode `{kv}` (expected 'paged')")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._family_mod = _family(model)
        self.device = resolve_device(device)
        self._family_mod.check_kernel_shapes(cfg, self.device)
        self.model = model
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len or cfg.max_seq_len
        self.kv = kv
        self.max_pending = max_pending
        if kv_pages is None:
            self._pool = PagePool.dense_equivalent(
                slots, self.max_len, page_size, prefix_cache=prefix_cache)
        else:
            if kv_pages < 1:
                raise ValueError(f"kv_pages must be >= 1, got {kv_pages}")
            self._pool = PagePool(slots, self.max_len, page_size,
                                  kv_pages + 1, prefix_cache=prefix_cache)
        self._cache = self._family_mod.paged_init_cache(
            cfg, self._pool.n_pages, page_size, device=self.device)

        self._pos = np.full(slots, -1, np.int64)  # -1 = free slot
        self._cur = np.zeros(slots, np.int64)
        self._slot_req: list[Optional[_Request]] = [None] * slots
        self._gens: list[Optional[torch.Generator]] = [None] * slots

        self._queue: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._stopped = False
        self._served = 0
        self._tokens_out = 0
        self._rejected: dict[str, int] = {}
        self._step_failures = 0
        self._consec_step_failures = 0
        # A device that throws persistently (e.g. OOM) fails fast after
        # this many consecutive failures instead of burning one rebuilt
        # cache per queued request.
        self.max_step_failures = 3
        self._steps_total = 0
        self._live_slot_steps = 0
        self._queue_depth_peak = 0
        self._step_seconds: collections.deque = collections.deque(maxlen=4096)
        # Cache-affinity admission: scan a bounded window of the queue
        # for the admissible request with the most cached tokens; one
        # overtaken `_admit_skip_cap` times becomes a barrier.
        self._admit_window = 32
        self._admit_skip_cap = 16
        self._prefill_tokens_total = 0
        self._prefill_tokens_skipped = 0
        self._hit_window: collections.deque = collections.deque(maxlen=64)
        self._hit_window_min = 8

        self._thread = threading.Thread(
            target=self._loop, name="plx-torch-batcher", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public
    def _validate(self, tokens: list[int], max_new_tokens: int) -> None:
        if not tokens:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self._family_mod.cb_validate(self.cfg, len(tokens), max_new_tokens,
                                     self.max_len)
        # A request that cannot fit the pool even alone would wait at the
        # queue head forever: reject it up front. Written positions span
        # 0..len+max_new-2.
        need = self._pool.pages_for(len(tokens) + max_new_tokens - 1)
        capacity = self._pool.n_pages - 1
        if need > capacity:
            raise ValueError(
                f"request needs {need} KV pages (prompt {len(tokens)} "
                f"+ {max_new_tokens} new) but the pool holds {capacity}; "
                "raise --kv-pages or shorten the request")

    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               top_p: float = 1.0, top_k: int = 0,
               eos_tokens=None) -> _Request:
        self._validate(tokens, max_new_tokens)
        validate_sampling(top_p, top_k)
        eos = frozenset(int(t) for t in (eos_tokens or ()))
        req = _Request(list(tokens), max_new_tokens, float(temperature),
                       int(seed), float(top_p), int(top_k), eos)
        with self._cv:
            if self._stopped:
                self._reject("shutdown")
                raise RuntimeError("engine stopped")
            depth = len(self._queue)
            if self.max_pending is not None and depth >= self.max_pending:
                self._reject("queue_full")
                raise QueueFull(
                    f"pending queue is full ({depth}/{self.max_pending}); "
                    "retry later",
                    retry_after=max(1, depth // max(self.slots, 1)))
            self._queue.append(req)
            self._cv.notify()
        return req

    def _reject(self, reason: str) -> None:
        self._rejected[reason] = self._rejected.get(reason, 0) + 1

    def cancel(self, req: _Request) -> None:
        """Drop a request: dequeued if still waiting, retired at the next
        loop iteration if live. Waiters see error='cancelled'."""
        req.cancelled = True
        with self._cv:
            try:
                self._queue.remove(req)
            except ValueError:
                return  # live in a slot (or done): the loop retires it
            if not req.done.is_set():
                req.error = "cancelled"
                req.done.set()

    def submit_all(self, token_rows: list[list[int]], max_new_tokens: int,
                   temperature: float = 0.0, seed: int = 0,
                   top_p: float = 1.0, top_k: int = 0,
                   eos_tokens=None) -> list[_Request]:
        """Validate every row before submitting any; if a later submit
        is shed, cancel the rows already queued and re-raise."""
        for row in token_rows:
            self._validate(row, max_new_tokens)
        reqs: list[_Request] = []
        try:
            for i, row in enumerate(token_rows):
                reqs.append(self.submit(row, max_new_tokens, temperature,
                                        seed + i, top_p, top_k,
                                        eos_tokens=eos_tokens))
        except Exception:
            for r in reqs:
                self.cancel(r)
            raise
        return reqs

    def generate(self, token_rows: list[list[int]], max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 top_p: float = 1.0, top_k: int = 0,
                 timeout: Optional[float] = None,
                 eos_tokens=None) -> list[list[int]]:
        if not token_rows:
            return []
        reqs = self.submit_all(token_rows, max_new_tokens, temperature,
                               seed, top_p, top_k, eos_tokens=eos_tokens)
        try:
            return [r.wait(timeout=timeout) for r in reqs]
        except TimeoutError:
            for r in reqs:
                if not r.done.is_set():
                    self.cancel(r)
            raise

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            # A long step is still in flight; release the waiters once the
            # loop exits instead of hanging stop() on a wedged device.
            logger.warning("batching loop still draining at stop(); "
                           "waiters will be released when it exits")
            threading.Thread(target=self._finalize_stop,
                             name="plx-torch-batcher-finalize",
                             daemon=True).start()
            return
        self._finalize_stop()

    def _finalize_stop(self) -> None:
        """After the loop thread has exited, unblock every waiter it will
        never serve."""
        self._thread.join()
        with self._cv:
            for req in list(self._queue) + self._slot_req:
                if req is not None and not req.done.is_set():
                    req.error = "engine stopped"
                    req.done.set()

    def check_invariants(self) -> list[str]:
        """The page pool's refcount/CoW cross-check (empty = sound)."""
        return self._pool.check_invariants()

    def health(self) -> dict:
        denom = sum(p for _, p in self._hit_window)
        return {
            "status": "stopped" if self._stopped else "ok",
            "model": self.model,
            "engine": "continuous",
            "device": str(self.device),
            "queued": len(self._queue),
            "active": sum(1 for r in self._slot_req if r is not None),
            "slots": self.slots,
            "max_pending": self.max_pending,
            "radix_hit_rate": (
                round(sum(s for s, _ in self._hit_window) / denom, 4)
                if len(self._hit_window) >= self._hit_window_min and denom
                else None),
            "kv_headroom": self._pool.utilization(),
        }

    def stats(self) -> dict:
        """Live engine counters + occupancy gauges for /v1/stats."""
        steps = list(self._step_seconds)
        return {
            "engine": "continuous",
            "device": str(self.device),
            "slots": self.slots,
            "active": sum(1 for r in self._slot_req if r is not None),
            "queued": len(self._queue),
            "queue_depth_peak": self._queue_depth_peak,
            "decode_steps": self._steps_total,
            "avg_occupancy": (
                round(self._live_slot_steps
                      / (self._steps_total * self.slots), 4)
                if self._steps_total else None),
            # Host wall time of one decode step, which ends in the copy
            # of the next tokens to the host (so it includes the device).
            "decode_step_ms_median": (
                statistics.median(steps) * 1e3 if steps else None),
            "requests_served": self._served,
            "tokens_generated": self._tokens_out,
            "step_failures": self._step_failures,
            "rejected": dict(self._rejected),
            "stopped": self._stopped,
            "kv": self.kv,
            "kv_pages_total": self._pool.n_pages - 1,
            "kv_pages_free": self._pool.free_pages,
            "kv_page_size": self._pool.page_size,
            "kv_prefix_hits": self._pool.prefix_hits,
            "kv_prefix_misses": self._pool.prefix_misses,
            "prefill_tokens_total": self._prefill_tokens_total,
            "prefill_tokens_skipped": self._prefill_tokens_skipped,
            "kv_prefix_hit_rate": (
                round(self._prefill_tokens_skipped
                      / self._prefill_tokens_total, 4)
                if self._prefill_tokens_total else None),
            "kv_cow_forks": self._pool.cow_forks,
            "kv_prefix_evictions": self._pool.prefix_evictions,
            "kv_radix": self._pool.radix_stats(),
            "kv_invariant_violations": len(self._pool.check_invariants()),
        }

    # -------------------------------------------------------------- loop
    def _loop(self) -> None:
        with torch.no_grad():
            while True:
                with self._cv:
                    while (not self._stopped and not self._queue
                           and all(r is None for r in self._slot_req)):
                        self._cv.wait()
                    if self._stopped:
                        return
                if not self._tick():
                    return

    def _tick(self) -> bool:
        """One engine iteration: drop cancellations, admit, one decode
        step. Returns False when fail-fast stopped the engine."""
        for b in range(self.slots):
            req = self._slot_req[b]
            if req is not None and req.cancelled:
                self._retire(b)
        self._admit()
        if self._stopped:  # admission may fail-fast mid-pass
            return False
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self._queue))
        live = sum(1 for r in self._slot_req if r is not None)
        if live == 0:
            return True
        self._steps_total += 1
        self._live_slot_steps += live
        return self._plain_step()

    def _pick_next_locked(self) -> Optional[_Request]:
        """Next request to admit (caller holds ``_cv``): within a bounded
        window of the FIFO queue, the admissible request whose prompt has
        the most radix-cached tokens (strict ``>`` keeps FIFO among ties);
        a request skipped ``_admit_skip_cap`` times is a barrier. None =
        nothing fits the pool right now (backpressure)."""
        q = self._queue
        best_i, best_score = None, -1.0
        for i in range(min(len(q), self._admit_window)):
            req = q[i]
            barrier = req.admit_skips >= self._admit_skip_cap
            if self._pool.can_admit(len(req.tokens), req.tokens):
                score = (float("inf") if barrier else
                         float(self._pool.peek_matched_tokens(
                             len(req.tokens), req.tokens)))
                if score > best_score:
                    best_i, best_score = i, score
            if barrier:
                break
        if best_i is None:
            return None
        for i in range(best_i):
            q[i].admit_skips += 1
        req = q[best_i]
        del q[best_i]
        return req

    def _note_prefix_outcome(self, req: _Request, res,
                             prefill_len: int) -> int:
        """Radix-reuse accounting; returns the prefill tokens to skip."""
        skip = min(res.matched_tokens, prefill_len)
        req.prefix_cached_tokens = skip
        self._prefill_tokens_total += prefill_len
        self._prefill_tokens_skipped += skip
        self._hit_window.append((skip, prefill_len))
        return skip

    def _admit(self) -> None:
        for b in range(self.slots):
            if self._slot_req[b] is not None:
                continue
            with self._cv:
                if not self._queue:
                    break
                req = self._pick_next_locked()
                if req is None:
                    break  # nothing fits: wait for retirements
            admit_res = self._pool.admit(b, len(req.tokens), req.tokens)
            if not admit_res:
                with self._cv:  # can_admit raced: back to the head
                    self._queue.appendleft(req)
                break
            try:
                pos0, tok0, prefill_tokens = self._family_mod.cb_admission(
                    req.tokens)
                skip = self._note_prefix_outcome(
                    req, admit_res, len(prefill_tokens or ()))
                if admit_res.cow is not None:
                    # Fork the partially shared page once on device; the
                    # suffix prefill then writes only the divergent tokens.
                    self._copy_page(*admit_res.cow)
                if prefill_tokens and skip < len(prefill_tokens):
                    if skip > 0:
                        self._prefill_suffix(b, prefill_tokens, skip)
                    else:
                        self._prefill_full(b, prefill_tokens)
                # The prefill (or a full cache hit) wrote the pages this
                # admission registered: its radix leaf now outlives the slot.
                self._pool.commit_prefix(b)
                self._go_live(b, req, pos0, tok0)
            except Exception as exc:  # noqa: BLE001 — request-scoped
                logger.exception("admission prefill failed")
                # Free the pages AND forget prefix keys for content the
                # prefill never wrote.
                self._pool.release(b, invalidate_prefix=True)
                req.error = f"{type(exc).__name__}: {exc}"
                req.done.set()
                if not self._count_request_failure(exc):
                    return

    def _copy_page(self, src: int, dst: int) -> None:
        for arr in self._cache.values():
            arr[:, dst] = arr[:, src]

    def _page_ids(self, b: int) -> torch.Tensor:
        return torch.as_tensor(self._pool.padded_row(b), dtype=torch.long,
                               device=self.device)

    def _prefill_full(self, b: int, prefill_tokens: list) -> None:
        row = torch.tensor([prefill_tokens], dtype=torch.long,
                           device=self.device)
        k_all, v_all = self._family_mod.paged_prefill_kv(
            self.cfg, self.params, row)
        self._family_mod.paged_insert_prefill(
            self._cache, k_all, v_all, self._page_ids(b),
            self._pool.page_size)

    def _prefill_suffix(self, b: int, prefill_tokens: list,
                        skip: int) -> None:
        """Partial radix hit: compute KV only for the novel suffix,
        attending the matched prefix pages read from the pool. The suffix
        is padded to its power-of-two bucket; padded positions write the
        scratch page."""
        ps = self._pool.page_size
        suffix = prefill_tokens[skip:]
        n_pref = -(-skip // ps)
        padded = np.zeros(bucket_suffix_len(len(suffix)), np.int64)
        padded[:len(suffix)] = suffix
        page_ids = self._page_ids(b)
        pref = page_ids[:n_pref].clamp(min=0)
        kp = self._cache["k"][:, pref].flatten(1, 2)  # [L, n_pref*ps, KV, Hd]
        vp = self._cache["v"][:, pref].flatten(1, 2)
        k_suf, v_suf = self._family_mod.paged_prefill_suffix_kv(
            self.cfg, self.params,
            torch.as_tensor(padded[None], device=self.device), kp, vp, skip)
        self._family_mod.paged_insert_suffix(
            self._cache, k_suf, v_suf, page_ids, skip, ps,
            real_len=len(suffix))

    def _go_live(self, b: int, req: _Request, pos0: int, tok0: int) -> None:
        self._slot_req[b] = req
        self._pos[b] = pos0
        self._cur[b] = tok0
        self._gens[b] = None
        if req.temperature > 0:
            self._gens[b] = torch.Generator(device=self.device)
            self._gens[b].manual_seed(req.seed)

    def _count_request_failure(self, exc: Exception) -> bool:
        """Only RuntimeErrors (device errors) count toward fail-fast; a
        ValueError is a bad request. Returns False when fail-fast stopped
        the engine."""
        if isinstance(exc, RuntimeError):
            self._step_failures += 1
            self._consec_step_failures += 1
            if self._consec_step_failures >= self.max_step_failures:
                self._fail_fast(f"{type(exc).__name__}: {exc}")
                return False
        return True

    def _fail_fast(self, err: str) -> None:
        """Persistent device breakage: fail live slots AND drain the
        queue, then stop the engine."""
        logger.error("%d consecutive device failures; draining queue and "
                     "stopping engine", self._consec_step_failures)
        for b in range(self.slots):
            if self._slot_req[b] is not None:
                self._slot_req[b].error = f"engine failed: {err}"
                self._retire(b)
        with self._cv:
            self._stopped = True
            while self._queue:
                req = self._queue.popleft()
                if not req.done.is_set():
                    req.error = f"engine failed: {err}"
                    req.done.set()

    def _handle_step_failure(self, exc: Exception) -> bool:
        """Fail every live request with the error, count toward the
        fail-fast budget, and rebuild the pool's cache (a failed step may
        have written part of it). Returns False when fail-fast stopped
        the engine. Called from an ``except`` block."""
        logger.exception("decode step failed")
        self._step_failures += 1
        self._consec_step_failures += 1
        err = f"{type(exc).__name__}: {exc}"
        for b in range(self.slots):
            if self._slot_req[b] is not None:
                self._slot_req[b].error = err
                self._retire(b)
        if self._consec_step_failures >= self.max_step_failures:
            self._fail_fast(err)
            return False
        self._cache = self._family_mod.paged_init_cache(
            self.cfg, self._pool.n_pages, self._pool.page_size,
            device=self.device)
        self._pool.invalidate_prefix_cache()  # resident pages are zeros now
        return True

    def _retire(self, b: int) -> None:
        req = self._slot_req[b]
        self._slot_req[b] = None
        self._pos[b] = -1
        self._gens[b] = None
        self._pool.release(b)
        if req is not None:
            if req.cancelled and not req.error:
                req.error = "cancelled"
            if not req.error:
                self._served += 1
                self._tokens_out += len(req.out)
            req.done.set()

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Next token per slot: argmax for greedy rows; a draw from the
        row's own generator for temperature > 0 (through ``sample_row``
        when top-p/top-k filter the row)."""
        nxt = logits.argmax(dim=-1)
        for b, req in enumerate(self._slot_req):
            if req is None or req.temperature <= 0:
                continue
            if req.top_p < 1.0 or req.top_k > 0:
                tok = sample_row(logits[b], self._gens[b], req.temperature,
                                 req.top_p, req.top_k)
            else:
                probs = torch.softmax(logits[b] / max(req.temperature, 1e-6),
                                      dim=-1)
                tok = torch.multinomial(probs, 1, generator=self._gens[b])[0]
            nxt[b] = tok
        return nxt.cpu().numpy()

    def _plain_step(self) -> bool:
        """One decode step for every slot. Returns False when fail-fast
        stopped the engine."""
        t0 = time.perf_counter()
        try:
            logits, self._cache = self._family_mod.decode_step_paged(
                self.cfg, self.params, self._cache,
                torch.as_tensor(self._cur, device=self.device),
                torch.as_tensor(self._pos, device=self.device),
                torch.as_tensor(self._pool.tables, dtype=torch.long,
                                device=self.device))
            nxt = self._sample(logits)
        except Exception as exc:  # noqa: BLE001 — fail live requests
            return self._handle_step_failure(exc)
        self._step_seconds.append(time.perf_counter() - t0)
        self._consec_step_failures = 0
        for b in range(self.slots):
            req = self._slot_req[b]
            if req is None:
                continue
            tok = int(nxt[b])
            req.out.append(tok)
            self._pos[b] += 1
            self._cur[b] = tok
            if len(req.out) >= req.max_new or tok in req.eos:
                self._retire(b)
            elif not self._pool.ensure(b, int(self._pos[b])):
                # An oversubscribed pool ran dry mid-generation: fail THIS
                # row loudly rather than let it write a neighbour's pages.
                req.error = (
                    "kv page pool exhausted mid-generation "
                    f"(pos {int(self._pos[b])}); raise --kv-pages "
                    "or lower concurrency")
                self._retire(b)
        return True
