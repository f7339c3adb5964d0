"""Continuous batching (port of ``polyaxon_tpu/serving/batching.py``).

A fixed pool of KV-cache **slots** advances every live request one token
per loop iteration (the family's ``decode_step_ragged`` over a dense
ring-buffer cache, or ``decode_step_paged`` over a page pool — each slot
at its own depth), and queued requests are admitted into freed slots
between iterations. On top of that loop, as in the JAX package:

- ``kv="dense"`` (the default): one ``[slots, max_len]`` row per slot;
  admission prefills the prompt into a row cache and inserts it;
- ``kv="paged"``: a shared page pool with a radix prefix cache
  (``serving/paged.py``): matched pages are adopted, a mid-page
  divergence is forked copy-on-write, and only the novel suffix is
  prefilled (bucketed to a power of two);
- chunked prefill (``prefill_chunk``, dense): a long prompt streams into
  a standalone row cache one chunk per iteration through
  ``decode_chunk``, interleaved with the live slots' decode steps;
- prefill lanes (``prefill_slots``, paged): admissions land on extra
  block-table rows, stream their suffix in chunks and hand their pages
  to a free decode slot (``PagePool.handoff``);
- draft speculation (``draft``, dense, greedy): each iteration is one
  draft→verify round whose length a ``SpeculationPolicy`` picks;
- request classes (``interactive`` / ``batch`` / ``best-effort``): per-
  class queues ranked by (priority, TTFT urgency, radix hotness, age),
  per-class pending caps, and preemptive eviction of a best-effort slot
  for a blocked interactive request (paged);
- request traces (``obs/reqtrace.py``) behind ``request_timeline`` and
  the serving metrics, recorded into ``registry`` (a component-scoped
  view behind a fleet).

The caches live on the engine's device and are updated in place; greedy,
temperature and top-p/top-k rows share one step, each sampled row
drawing from its own generator seeded by the request. On a CUDA device a
config whose head_dim the kernels do not take is refused at
construction. Any family with the ragged-decode surface batches
continuously: llama decoders, MoE decoders (the expert FFN in the MLP
slot) and t5 (per-slot encoder state in the pool cache; dense cache only,
no chunked prefill or speculation).
"""

from __future__ import annotations

import collections
import logging
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from polyaxon_tpu_torch.device import resolve_device
from polyaxon_tpu_torch.models import llama, moe, t5
from polyaxon_tpu_torch.models.common import sample_row
from polyaxon_tpu_torch.obs import metrics as obs_metrics
from polyaxon_tpu_torch.obs import reqtrace
from polyaxon_tpu_torch.serving.gang import OPS
from polyaxon_tpu_torch.serving.paged import PagePool
from polyaxon_tpu_torch.serving.speculative import LaneView, SpeculationPolicy

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


@dataclass(frozen=True)
class RequestClass:
    """One named serving class: a numeric priority orders admission
    across classes, a TTFT target marks a request overdue inside the
    rank tuple, and the preemption flags say who may evict whom.
    ``skip_cap`` is the within-class starvation barrier: a request
    overtaken that many times blocks younger requests of its own class
    (across classes priority is strict; the per-class pending cap bounds
    that starvation)."""

    name: str
    priority: int          # higher admits first
    ttft_target: float     # seconds; past it the request is "overdue"
    preemptible: bool      # may be evicted from a live slot
    preempts: bool         # may trigger eviction when blocked
    skip_cap: int          # within-class starvation barrier


REQUEST_CLASSES: dict[str, RequestClass] = {
    "interactive": RequestClass("interactive", priority=2,
                                ttft_target=0.5, preemptible=False,
                                preempts=True, skip_cap=4),
    "batch": RequestClass("batch", priority=1, ttft_target=2.5,
                          preemptible=False, preempts=False,
                          skip_cap=16),
    "best-effort": RequestClass("best-effort", priority=0,
                                ttft_target=30.0, preemptible=True,
                                preempts=False, skip_cap=64),
}
DEFAULT_REQUEST_CLASS = "batch"


def resolve_request_class(name: str) -> RequestClass:
    """Catalog lookup; unknown class names fold to the default class, so
    an arbitrary label can never mint priority or preemption rights."""
    return REQUEST_CLASSES.get(name, REQUEST_CLASSES[DEFAULT_REQUEST_CLASS])


def validate_sampling(top_p: float, top_k: int) -> None:
    """Out-of-range sampling knobs raise instead of degenerating."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")


def _family(model: str):
    """The model family module serving ``model``, with CONFIGS, init,
    generate and a SEQ2SEQ flag: llama decoders, Mixtral-style MoE
    decoders and t5 encoder-decoders."""
    for mod in (llama, moe, t5):
        if model in mod.CONFIGS:
            return mod
    raise ValueError(
        f"model `{model}` is not servable; decoders: "
        f"{sorted(llama.CONFIGS) + sorted(moe.CONFIGS)}, "
        f"seq2seq: {sorted(t5.CONFIGS)}")


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
    # The id doubles as the trace id; `klass` picks the admission queue
    # and labels the SLO histograms; `first_token_at` anchors TTFT.
    id: str = field(default_factory=reqtrace.new_request_id)
    klass: str = "batch"
    trace: Optional[reqtrace.RequestTrace] = None
    first_token_at: Optional[float] = None
    # Times a younger request was admitted past this one (the bound on
    # starvation by the cache-affinity scan).
    admit_skips: int = 0
    prefix_cached_tokens: int = 0
    # Global arrival order (the FIFO tie-breaker across class queues) and
    # the evictions this request survived.
    seq: int = 0
    preemptions: int = 0

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
                 max_len: Optional[int] = None, kv: str = "dense",
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 draft=None, prefill_chunk: Optional[int] = None,
                 prefill_slots: Optional[int] = None,
                 prefill_lane_budget: int = 1,
                 decode_lane_budget: int = 1,
                 spec_policy: Optional[SpeculationPolicy] = None,
                 max_pending: Optional[int] = None,
                 class_admission: bool = True,
                 class_max_pending: Optional[dict] = None,
                 preemption: bool = True,
                 request_tracing: bool = True,
                 trace_capacity: int = reqtrace.DEFAULT_RING_CAPACITY,
                 trace_dump_path: Optional[str] = None,
                 registry=None, device=None, gang=None):
        family = _family(model)
        if prefill_slots is not None:
            if prefill_slots < 1:
                raise ValueError(
                    f"prefill_slots must be >= 1, got {prefill_slots}")
            if kv != "paged":
                raise ValueError(
                    "disaggregated prefill/decode requires kv='paged' "
                    "(the handoff boundary is a block-table row move)")
            if draft is not None:
                raise ValueError(
                    "prefill_slots and draft are mutually exclusive: "
                    "the draft's verify chunk needs kv='dense' while "
                    "the page handoff needs kv='paged'")
            if not (hasattr(family, "paged_prefill_suffix_kv")
                    and hasattr(family, "paged_insert_suffix")):
                raise ValueError(
                    f"`{model}` ({family.__name__}) has no paged suffix-"
                    "prefill surface; the prefill lane streams chunks "
                    "through paged_prefill_suffix_kv")
        if prefill_lane_budget < 1:
            raise ValueError(f"prefill_lane_budget must be >= 1, got "
                             f"{prefill_lane_budget}")
        if decode_lane_budget < 0:
            raise ValueError(f"decode_lane_budget must be >= 0, got "
                             f"{decode_lane_budget}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if kv != "dense" and prefill_slots is None:
                raise ValueError(
                    "chunked prefill requires kv='dense' (the chunk "
                    "writer needs the slot==position row cache) — or "
                    "prefill_slots, where it sizes the lane's per-tick "
                    "suffix chunk instead")
            if kv == "dense" and not hasattr(family, "decode_chunk"):
                raise ValueError(
                    f"`{model}` ({family.__name__}) has no decode_chunk "
                    "surface; chunked prefill supports llama/moe-family "
                    "decoders")
            if kv == "dense" and getattr(cfg, "sliding_window",
                                         None) is not None:
                raise ValueError(
                    "chunked prefill requires a full-length cache "
                    "(no sliding_window): the padded tail chunk's "
                    "junk writes rely on slot == position")
        if draft is not None:
            if kv != "dense":
                raise ValueError(
                    "speculative continuous batching requires kv='dense' "
                    "(the verify chunk needs the slot==position cache)")
            if getattr(cfg, "sliding_window", None) is not None:
                raise ValueError(
                    "speculative decoding requires a full-length cache "
                    "(no sliding_window) — rollback-free acceptance "
                    "depends on slot == position")
            if not hasattr(family, "decode_chunk"):
                raise ValueError(
                    f"`{model}` ({family.__name__}) has no decode_chunk "
                    "verify surface; speculative continuous batching "
                    "supports llama/moe-family decoders")
        required = ("decode_step_ragged", "cb_init_cache", "cb_prefill",
                    "cb_admission", "cb_validate", "insert_cache_row")
        if kv == "paged":
            required += ("decode_step_paged", "paged_init_cache",
                         "paged_prefill_kv", "paged_insert_prefill")
        elif kv != "dense":
            raise ValueError(f"unknown kv mode `{kv}` "
                             "(expected 'dense' or 'paged')")
        missing = [name for name in required if not hasattr(family, name)]
        if missing:
            alt = "kv='dense'" if kv == "paged" else "the static engine"
            raise ValueError(
                f"continuous batching needs the ragged-decode surface; "
                f"`{model}` ({family.__name__}) lacks {missing} — use {alt}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = resolve_device(device)
        family.check_kernel_shapes(cfg, self.device, paged=kv == "paged")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len or cfg.max_seq_len
        # Under a serving gang (``serving/gang.py``) every model call and
        # pool op runs on every rank; ``params`` is then its marker.
        self._gang = gang
        self._family_mod = (family if gang is None
                            else gang.family("target", family))
        # Behind a fleet `registry` is a component-scoped view: every
        # series this engine records carries the replica's identity, and
        # its trace spans name the replica instead of "serving".
        self._obs = registry if registry is not None else obs_metrics.REGISTRY
        self._obs_component = (getattr(self._obs, "component", "")
                               or "serving")
        self.kv = kv
        self._pool: Optional[PagePool] = None
        # Prefill-lane rows sit after the decode slots in the block table
        # (rows slots..slots+prefill_slots-1): the decode step's
        # [slots]-row slice never sees them, and a handoff is a row move
        # inside the same pool.
        self.prefill_slots = int(prefill_slots or 0)
        n_rows = slots + self.prefill_slots
        if kv == "paged":
            if kv_pages is None:
                self._pool = PagePool.dense_equivalent(
                    n_rows, self.max_len, page_size,
                    prefix_cache=prefix_cache)
            else:
                # kv_pages counts usable pages; the scratch page is
                # internal.
                if kv_pages < 1:
                    raise ValueError(
                        f"kv_pages must be >= 1, got {kv_pages}")
                self._pool = PagePool(n_rows, self.max_len, page_size,
                                      kv_pages + 1,
                                      prefix_cache=prefix_cache)
        self._cache = self._new_cache()
        self.draft = draft
        self._spec_rounds = 0
        self._spec_tokens = 0
        if draft is not None:
            draft_model, draft_cfg, draft_params, spec_k = draft
            if getattr(draft_cfg, "sliding_window", None) is not None:
                raise ValueError(
                    "draft model must not use sliding_window (its cache "
                    "needs slot == position too)")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            self._draft_family = _family(draft_model)
            if gang is not None:
                self._draft_family = gang.family("draft",
                                                 self._draft_family)
            if getattr(self._draft_family, "SEQ2SEQ", False):
                raise ValueError(
                    f"draft `{draft_model}` is seq2seq — a drafting "
                    "decoder must continue the same token stream the "
                    "target decodes (its proposals would be garbage "
                    "and acceptance would silently collapse)")
            self._draft_family.check_kernel_shapes(draft_cfg, self.device,
                                                   paged=False)
            self._draft_cfg = draft_cfg
            self._draft_params = draft_params
            self.spec_k = int(spec_k)
            self._draft_cache = self._draft_family.cb_init_cache(
                draft_cfg, slots, self.max_len, device=self.device)
        self.prefill_chunk = prefill_chunk
        # Lane state (paged disaggregation): prefill row → [request,
        # prefill tokens, progress, pos0, tok0]; insertion order is the
        # staging FIFO. A finished reservation waits in place for a free
        # decode slot.
        self.prefill_lane_budget = int(prefill_lane_budget)
        self.decode_lane_budget = int(decode_lane_budget)
        self._lane: dict[int, list] = {}
        self._lane_chunk = (int(prefill_chunk) if prefill_chunk
                            else max(2 * page_size, 32))
        self._handoffs = 0
        self._handoff_pages = 0
        self._last_decode_at: Optional[float] = None
        # Dense chunked-prefill state per reserved slot: [request, prompt
        # tokens to write, progress, target row cache, draft row cache or
        # None, pos0, tok0]; insertion order is the admission FIFO. Each
        # reservation holds a standalone full-length row cache.
        self._prefilling: dict[int, list] = {}
        self._pos = np.full(slots, -1, np.int64)  # -1 = free slot
        self._cur = np.zeros(slots, np.int64)
        self._slot_req: list[Optional[_Request]] = [None] * slots
        self._gens: list[Optional[torch.Generator]] = [None] * slots

        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        # Class-aware admission: per-class queues (FIFO within a class,
        # arrival `seq` across classes). Off, every request lands in one
        # queue and the FIFO-with-cache-affinity scan runs.
        self.class_admission = bool(class_admission)
        self.preemption = bool(preemption)
        self._class_caps: dict[str, int] = {}
        for name, cap in (class_max_pending or {}).items():
            if cap is not None:
                cap = int(cap)
                if cap < 1:
                    raise ValueError(
                        f"class_max_pending[{name!r}] must be >= 1, "
                        f"got {cap}")
                self._class_caps[str(name)] = cap
        # Created for every reachable key up front, so the dict never
        # grows and unlocked readers iterate it safely.
        self._queues: dict[str, collections.deque] = {
            name: collections.deque()
            for name in (REQUEST_CLASSES if self.class_admission
                         else (DEFAULT_REQUEST_CLASS,))}
        self._seq = 0
        self._preemptions: dict[str, int] = {}
        self._readmit_suffix_tokens = 0
        self.request_tracing = bool(request_tracing)
        self._ring = reqtrace.TimelineRing(trace_capacity)
        self.trace_dump_path = trace_dump_path
        self._rejected: dict[str, int] = {}
        self._cv = threading.Condition()
        self._stopped = False
        self._served = 0
        self._tokens_out = 0
        self._step_failures = 0
        self._consec_step_failures = 0
        self._steps_total = 0
        self._live_slot_steps = 0
        self._queue_depth_peak = 0
        self._step_seconds: collections.deque = collections.deque(maxlen=4096)
        # A device that throws persistently (e.g. OOM) fails fast after
        # this many consecutive failures instead of burning one rebuilt
        # cache per queued request.
        self.max_step_failures = 3
        # Cache-affinity admission: scan a bounded window of the queue
        # for the admissible request with the most cached tokens; one
        # overtaken `_admit_skip_cap` times becomes a barrier.
        self._admit_window = 32
        self._admit_skip_cap = 16
        self._prefill_tokens_total = 0
        self._prefill_tokens_skipped = 0
        self._hit_window: collections.deque = collections.deque(maxlen=64)
        self._hit_window_min = 8
        # Speculation as a policy output: each decode tick asks the
        # policy for the draft length (0 = a plain decode step).
        self._spec_policy = None
        self._spec_proposed = 0
        self._spec_accepted = 0
        if draft is not None:
            self._spec_policy = (spec_policy if spec_policy is not None
                                 else SpeculationPolicy(self.spec_k))

        self._thread = threading.Thread(
            target=self._loop, name="plx-torch-batcher", daemon=True)
        self._thread.start()

    def _new_cache(self) -> dict:
        if self._pool is not None:
            return self._family_mod.paged_init_cache(
                self.cfg, self._pool.n_pages, self._pool.page_size,
                device=self.device)
        return self._family_mod.cb_init_cache(self.cfg, self.slots,
                                              self.max_len,
                                              device=self.device)

    # ------------------------------------------------------------ public
    def _validate(self, tokens: list[int], max_new_tokens: int) -> None:
        if not tokens:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self._family_mod.cb_validate(self.cfg, len(tokens), max_new_tokens,
                                     self.max_len)
        if self.draft is not None:
            # Verify rounds write KV up to k positions past the budget.
            need = len(tokens) + max_new_tokens + self.spec_k + 1
            if need > self.max_len:
                raise ValueError(
                    f"prompt {len(tokens)} + max_new {max_new_tokens} + "
                    f"draft window {self.spec_k}+1 exceeds the cache "
                    f"length {self.max_len} (speculative rounds need "
                    "the headroom)")
        if self._pool is not None:
            # A request that cannot fit the pool even alone would wait at
            # the queue head forever: reject it up front. Written
            # positions span 0..len+max_new-2.
            need = self._pool.pages_for(len(tokens) + max_new_tokens - 1)
            capacity = self._pool.n_pages - 1
            if need > capacity:
                raise ValueError(
                    f"request needs {need} KV pages (prompt {len(tokens)} "
                    f"+ {max_new_tokens} new) but the pool holds "
                    f"{capacity}; raise --kv-pages or shorten the request")

    def _reject(self, reason: str) -> None:
        self._rejected[reason] = self._rejected.get(reason, 0) + 1
        obs_metrics.serving_rejected_total(self._obs).inc(reason=reason)

    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               top_p: float = 1.0, top_k: int = 0,
               eos_tokens=None, klass: str = "batch",
               request_id: Optional[str] = None,
               trace_parent: Optional[str] = None,
               route_record: Optional[dict] = None) -> _Request:
        """``request_id``/``trace_parent``/``route_record`` carry a
        propagated trace context: the fleet front door pre-generates the
        id and closes a ``route`` span, and this engine's ``request``
        root nests under it (one trace id, one timeline)."""
        self._validate(tokens, max_new_tokens)
        validate_sampling(top_p, top_k)
        eos = frozenset(int(t) for t in (eos_tokens or ()))
        if self.draft is not None and temperature > 0:
            raise ValueError(
                "this engine speculates with a draft model, which is "
                "greedy-only (acceptance compares the target's own "
                "argmax); send temperature=0 or serve without "
                "--draft-model for sampling")
        req = _Request(list(tokens), max_new_tokens, float(temperature),
                       int(seed), float(top_p), int(top_k), eos,
                       klass=str(klass) or "batch")
        if request_id:
            req.id = str(request_id)
        if self.request_tracing:
            # Ringed only after a successful enqueue, so rejected
            # requests never occupy ring capacity.
            req.trace = reqtrace.RequestTrace(
                req.id, req.klass, component=self._obs_component,
                parent_id=trace_parent,
                extra_records=[route_record] if route_record else None,
                prompt_len=len(req.tokens), max_new=int(max_new_tokens))
            req.trace.start_phase("queue_wait")
        with self._cv:
            if self._stopped:
                self._reject("shutdown")
                raise RuntimeError("engine stopped")
            depth = self._queue_depth()
            if self.max_pending is not None and depth >= self.max_pending:
                self._reject("queue_full")
                raise QueueFull(
                    f"pending queue is full ({depth}/"
                    f"{self.max_pending}); retry later",
                    retry_after=max(1, depth // max(self.slots, 1)))
            key = self._queue_key(req.klass)
            q = self._queues[key]
            cap = (self._class_caps.get(key)
                   if self.class_admission else None)
            if cap is not None and len(q) >= cap:
                self._reject("class_queue_full")
                raise QueueFull(
                    f"`{key}` pending queue is full ({len(q)}/{cap}); "
                    f"retry later",
                    retry_after=max(1, len(q) // max(self.slots, 1)))
            req.seq = self._seq
            self._seq += 1
            q.append(req)
            self._publish_queue_depth()
            self._cv.notify()
        if req.trace is not None:
            self._ring.add(req.trace)
        return req

    def cancel(self, req: _Request) -> None:
        """Drop a request: dequeued if still waiting, retired at the next
        loop iteration if live. Waiters see error='cancelled'."""
        req.cancelled = True
        with self._cv:
            try:
                self._queue_for(req).remove(req)
            except ValueError:
                return  # live in a slot (or done): the loop retires it
            if not req.done.is_set():
                req.error = "cancelled"
                self._finish_trace(req)
                req.done.set()

    def submit_all(self, token_rows: list[list[int]], max_new_tokens: int,
                   temperature: float = 0.0, seed: int = 0,
                   top_p: float = 1.0, top_k: int = 0,
                   eos_tokens=None, klass: str = "batch") -> list[_Request]:
        """Validate every row before submitting any; if a later submit
        is shed, cancel the rows already queued and re-raise."""
        for row in token_rows:
            self._validate(row, max_new_tokens)
        reqs: list[_Request] = []
        try:
            for i, row in enumerate(token_rows):
                reqs.append(self.submit(
                    row, max_new_tokens, temperature, seed + i,
                    top_p, top_k, eos_tokens=eos_tokens, klass=klass))
        except Exception:
            for r in reqs:
                self.cancel(r)
            raise
        return reqs

    def generate(self, token_rows: list[list[int]], max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 top_p: float = 1.0, top_k: int = 0,
                 timeout: Optional[float] = None,
                 eos_tokens=None, klass: str = "batch") -> list[list[int]]:
        if not token_rows:
            return []
        reqs = self.submit_all(token_rows, max_new_tokens, temperature,
                               seed, top_p, top_k, eos_tokens=eos_tokens,
                               klass=klass)
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
        never serve, and persist the trace ring if asked."""
        self._thread.join()
        with self._cv:
            pending = [state[0] for state in self._prefilling.values()]
            pending += [state[0] for state in self._lane.values()]
            for req in self._pending_requests() + self._slot_req + pending:
                if req is not None and not req.done.is_set():
                    req.error = "engine stopped"
                    self._finish_trace(req)
                    req.done.set()
        if self._hit_window:
            # A stopped engine's rolling window must not keep the shared
            # prefix-hit-rate gauge parked at its last value.
            obs_metrics.serving_prefix_hit_rate(self._obs).unset()
        self._dump_ring()

    def _dump_ring(self) -> None:
        """Persist the request-timeline ring at shutdown. Fail-open: a
        dump failure must not turn a clean stop into a crash; both
        outcomes are counted."""
        if not self.trace_dump_path or not self.request_tracing:
            return
        obs = getattr(self, "_obs", None) or obs_metrics.REGISTRY
        try:
            path = reqtrace.dump_ring(self._ring, self.trace_dump_path)
            obs_metrics.serving_trace_dumps_total(obs).inc(outcome="ok")
            logger.info("request-timeline ring dumped to %s", path)
        except Exception:
            obs_metrics.serving_trace_dumps_total(obs).inc(outcome="error")
            logger.warning("request-timeline ring dump to %s failed",
                           self.trace_dump_path, exc_info=True)

    def check_invariants(self) -> list[str]:
        """The page pool's refcount/CoW cross-check (empty = sound; a
        dense engine has no pool)."""
        return self._pool.check_invariants() if self._pool is not None else []

    def request_timeline(self, request_id: str) -> Optional[dict]:
        """Assembled span tree for one recent request (None = unknown or
        evicted from the ring): ``GET /requests/{id}/timeline``."""
        return self._ring.timeline(request_id)

    def recent_requests(self) -> list[dict]:
        """Ring summaries, most recent first: ``GET /requests``."""
        return self._ring.summaries()

    def health(self) -> dict:
        """Liveness and load for /healthz: queue depth, slot occupancy,
        per-class and per-lane depths, radix hit rate and KV headroom,
        the one surface a fleet router polls."""
        denom = sum(p for _, p in self._hit_window)
        return {
            "status": "stopped" if self._stopped else "ok",
            "model": self.model,
            "engine": "continuous",
            "device": str(self.device),
            "queued": self._queue_depth(),
            "active": sum(1 for r in self._slot_req if r is not None),
            "slots": self.slots,
            "max_pending": self.max_pending,
            "class_admission": self.class_admission,
            "class_pending": {name: len(q)
                              for name, q in self._queues.items()},
            "class_caps": dict(self._class_caps),
            "preemptions": dict(self._preemptions),
            "prefill_pending": (self._queue_depth()
                                + len(self._prefilling)
                                + len(self._lane)),
            "decode_active": sum(1 for r in self._slot_req
                                 if r is not None),
            "spec_tokens_accepted_rate": (
                round(self._spec_accepted / self._spec_proposed, 4)
                if self._spec_proposed else None),
            "radix_hit_rate": (
                round(sum(s for s, _ in self._hit_window) / denom, 4)
                if len(self._hit_window) >= self._hit_window_min and denom
                else None),
            "kv_headroom": (self._pool.utilization()
                            if self._pool is not None else None),
        }

    def stats(self) -> dict:
        """Live engine counters and occupancy gauges for /v1/stats."""
        steps = list(self._step_seconds)
        return {
            "engine": "continuous",
            "device": str(self.device),
            "slots": self.slots,
            "active": sum(1 for r in self._slot_req if r is not None),
            "prefilling": len(self._prefilling),
            "queued": self._queue_depth(),
            "queue_depth_peak": self._queue_depth_peak,
            "class_admission": self.class_admission,
            "preemptions": dict(self._preemptions),
            "readmit_suffix_tokens": self._readmit_suffix_tokens,
            "decode_steps": self._steps_total,
            "avg_occupancy": (
                round(self._live_slot_steps
                      / (self._steps_total * self.slots), 4)
                if self._steps_total else None),
            # Host wall time of one decode step (or speculative round),
            # which ends in the copy of the next tokens to the host (so
            # it includes the device).
            "decode_step_ms_median": (
                statistics.median(steps) * 1e3 if steps else None),
            "requests_served": self._served,
            "tokens_generated": self._tokens_out,
            "step_failures": self._step_failures,
            "rejected": dict(self._rejected),
            "request_tracing": self.request_tracing,
            "traced_requests": len(self._ring),
            "stopped": self._stopped,
            "kv": self.kv,
            **({"draft_model": self.draft[0],
                "spec_k": self.spec_k,
                "spec_rounds": self._spec_rounds,
                # Mean tokens emitted per verify round (1..k+1).
                "spec_tokens_per_round": (
                    round(self._spec_tokens / self._spec_rounds, 3)
                    if self._spec_rounds else None),
                "spec_policy_state": self._spec_policy.state,
                "spec_tokens_accepted_rate": (
                    round(self._spec_accepted / self._spec_proposed, 4)
                    if self._spec_proposed else None)}
               if self.draft is not None else {}),
            **({"prefill_slots": self.prefill_slots,
                "lane_staging": len(self._lane),
                "handoffs": self._handoffs,
                "handoff_pages": self._handoff_pages,
                "decode_lane_budget": self.decode_lane_budget}
               if self.prefill_slots else {}),
            **({"kv_pages_total": self._pool.n_pages - 1,
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
                "kv_invariant_violations": len(
                    self._pool.check_invariants())}
               if self._pool is not None else {}),
        }

    # --------------------------------------------------- pending queues
    def _queue_key(self, klass: str) -> str:
        """The pending queue a request class lands in (one queue when
        class admission is off)."""
        if not self.class_admission or klass not in REQUEST_CLASSES:
            return DEFAULT_REQUEST_CLASS
        return klass

    def _queue_for(self, req: _Request) -> collections.deque:
        return self._queues[self._queue_key(req.klass)]

    def _queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _queue_head(self) -> Optional[_Request]:
        """Oldest pending request across every class queue."""
        heads = [q[0] for q in self._queues.values() if q]
        return min(heads, key=lambda r: r.seq) if heads else None

    def _pending_requests(self) -> list[_Request]:
        return [r for q in self._queues.values() for r in q]

    def _publish_queue_depth(self) -> None:
        obs_metrics.serving_queue_depth(self._obs).set(self._queue_depth())
        if self.class_admission:
            gauge = obs_metrics.serving_class_pending(self._obs)
            for name, q in self._queues.items():
                gauge.set(len(q), **{"class": name})

    def _pick_next_locked(self) -> Optional[_Request]:
        """The next request to admit (caller holds ``_cv``).

        Dense: strict FIFO, or with class admission the head of the
        highest-priority class queue (arrival order among equals).

        Paged, FIFO mode: within a bounded window of the one queue, the
        admissible request whose prompt has the most radix-cached tokens
        (strict ``>`` keeps FIFO among ties); a request skipped
        ``_admit_skip_cap`` times is a barrier.

        Paged, class mode: every class queue's window is scanned and the
        rank tuple (class priority, overdue past the class TTFT target,
        matched-token hotness, age) picks the winner; the starvation
        barrier is per class. None = nothing admissible right now."""
        if self._pool is None:
            if not self.class_admission:
                return self._queues[DEFAULT_REQUEST_CLASS].popleft()
            best = None
            for name, q in self._queues.items():
                if not q:
                    continue
                key = (resolve_request_class(name).priority, -q[0].seq)
                if best is None or key > best[0]:
                    best = (key, q)
            return best[1].popleft() if best is not None else None
        if not self.class_admission:
            q = self._queues[DEFAULT_REQUEST_CLASS]
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
        now = time.time()
        best = None  # ((priority, overdue, hotness, -seq), queue, index)
        for name, q in self._queues.items():
            if not q:
                continue
            rc = resolve_request_class(name)
            for i in range(min(len(q), self._admit_window)):
                req = q[i]
                barrier = req.admit_skips >= rc.skip_cap
                if self._pool.can_admit(len(req.tokens), req.tokens):
                    hot = (float("inf") if barrier else
                           float(self._pool.peek_matched_tokens(
                               len(req.tokens), req.tokens)))
                    overdue = int(now - req.submitted_at > rc.ttft_target)
                    key = (rc.priority, overdue, hot, -req.seq)
                    if best is None or key > best[0]:
                        best = (key, q, i)
                if barrier:
                    break
        if best is None:
            return None
        _, q, best_i = best
        for i in range(best_i):
            q[i].admit_skips += 1  # within-class aging only
        req = q[best_i]
        del q[best_i]
        return req

    def _note_prefix_outcome(self, req: _Request, res,
                             prefill_len: int) -> int:
        """Radix-reuse accounting (counters, the rolling hit-rate gauge,
        the request's cached-token stamp); returns the prefill tokens to
        skip."""
        skip = min(res.matched_tokens, prefill_len)
        req.prefix_cached_tokens = skip
        outcome = ("full" if skip >= prefill_len
                   else "partial" if skip > 0 else "miss")
        obs_metrics.serving_prefix_hits_total(self._obs).inc(outcome=outcome)
        if skip:
            obs_metrics.serving_prefix_cached_tokens(self._obs).inc(skip)
        self._prefill_tokens_total += prefill_len
        self._prefill_tokens_skipped += skip
        self._hit_window.append((skip, prefill_len))
        if len(self._hit_window) >= self._hit_window_min:
            denom = sum(p for _, p in self._hit_window)
            if denom:
                obs_metrics.serving_prefix_hit_rate(self._obs).set(
                    sum(s for s, _ in self._hit_window) / denom)
        if res.cow is not None and req.trace is not None:
            req.trace.event("cow_fork", src=int(res.cow[0]),
                            dst=int(res.cow[1]))
        if req.preemptions:
            # Re-admission after eviction: the novel suffix is the real
            # recompute cost of the preemption.
            novel = max(prefill_len - skip, 0)
            if novel:
                self._readmit_suffix_tokens += novel
                obs_metrics.serving_readmit_suffix_tokens_total(
                    self._obs).inc(novel)
        return skip

    def _dequeue_for(self, row: int) -> Optional[tuple]:
        """Pick the next request and reserve its pages on ``row`` (paged):
        (request, admission result) or None when nothing is admitted
        now (empty queue or backpressure; a raced pool admission goes
        back to the queue head)."""
        with self._cv:
            if not self._queue_depth():
                return None
            req = self._pick_next_locked()
            if req is None:
                # Paged backpressure: annotate the head once per tick so
                # the timeline says why it waits.
                head = self._queue_head()
                if head is not None and head.trace is not None:
                    head.trace.event("kv_backpressure",
                                     pages_free=self._pool.free_pages)
                return None
            self._publish_queue_depth()
        admit_res = None
        if self._pool is not None:
            admit_res = self._pool.admit(row, len(req.tokens), req.tokens)
            if not admit_res:
                obs_metrics.serving_admissions_total(self._obs).inc(
                    outcome="deferred")
                if req.trace is not None:
                    req.trace.event("requeue", reason="kv_pages")
                with self._cv:
                    self._queue_for(req).appendleft(req)
                return None
        # Dequeued for real: close queue_wait and feed its histogram.
        obs_metrics.serving_queue_wait_hist(self._obs).observe(
            time.time() - req.submitted_at, **{"class": req.klass})
        if req.trace is not None:
            req.trace.end_phase(slot=row)
        return req, admit_res

    def _fail_admission(self, row: int, req: _Request,
                        exc: Exception) -> bool:
        """A request-scoped admission failure: pages freed and the fresh
        prefix leaf forgotten; returns False when fail-fast stopped the
        engine."""
        logger.exception("admission failed")
        if self._pool is not None:
            self._pool.release(row, invalidate_prefix=True)
        obs_metrics.serving_admissions_total(self._obs).inc(outcome="failed")
        req.error = f"{type(exc).__name__}: {exc}"
        self._finish_trace(req)
        req.done.set()
        return self._count_request_failure(exc)

    def _admit(self) -> None:
        for b in range(self.slots):
            if self._slot_req[b] is not None or b in self._prefilling:
                continue
            picked = self._dequeue_for(b)
            if picked is None:
                break
            req, admit_res = picked
            try:
                pos0, tok0, prefill_tokens = self._family_mod.cb_admission(
                    req.tokens)
                skip = 0
                if admit_res is not None:
                    skip = self._note_prefix_outcome(
                        req, admit_res, len(prefill_tokens or ()))
                    if admit_res.cow is not None:
                        # Fork the partially shared page once on device;
                        # the suffix prefill then writes only the
                        # divergent tokens.
                        self._copy_page(*admit_res.cow)
                if (prefill_tokens and self.prefill_chunk is not None
                        and len(prefill_tokens) > self.prefill_chunk):
                    # Long prompt: reserve the slot and stream the prompt
                    # in chunks across loop iterations.
                    if req.trace is not None:
                        req.trace.start_phase(
                            "prefill", mode="chunked",
                            prompt_tokens=len(prefill_tokens),
                            chunk=self.prefill_chunk)
                    row_t = self._family_mod.cb_init_cache(
                        self.cfg, 1, self.max_len, device=self.device)
                    row_d = (self._draft_family.cb_init_cache(
                        self._draft_cfg, 1, self.max_len,
                        device=self.device)
                        if self.draft is not None else None)
                    self._prefilling[b] = [
                        req, np.asarray(prefill_tokens, np.int64), 0,
                        row_t, row_d, pos0, tok0]
                    continue
                if prefill_tokens:
                    self._prefill_row(b, req, prefill_tokens, skip)
                if self._pool is not None:
                    # The prefill (or a full cache hit) wrote the pages
                    # this admission registered: its radix leaf now
                    # outlives the slot.
                    self._pool.commit_prefix(b)
                self._go_live(b, req, pos0, tok0)
            except Exception as exc:  # noqa: BLE001 — request-scoped
                if not self._fail_admission(b, req, exc):
                    return

    def _prefill_row(self, b: int, req: _Request, prefill_tokens: list,
                     skip: int) -> None:
        """Admission prefill of slot ``b``: nothing on a full radix hit,
        the novel suffix on a partial one, else the whole prompt (and the
        draft's row when speculating)."""
        if skip >= len(prefill_tokens):
            if req.trace is not None:
                req.trace.start_phase(
                    "prefill", mode="cached",
                    prompt_tokens=len(prefill_tokens), cached_tokens=skip)
            return
        if skip > 0:
            if req.trace is not None:
                req.trace.start_phase(
                    "prefill", mode="suffix",
                    prompt_tokens=len(prefill_tokens), cached_tokens=skip)
            suffix = prefill_tokens[skip:]
            self._suffix_prefill(b, suffix, -(-skip // self._pool.page_size),
                                 skip)
            return
        if req.trace is not None:
            req.trace.start_phase("prefill", mode="monolithic",
                                  prompt_tokens=len(prefill_tokens))
        row = torch.tensor([prefill_tokens], dtype=torch.long,
                           device=self.device)
        if self._pool is not None:
            k_all, v_all = self._family_mod.paged_prefill_kv(
                self.cfg, self.params, row)
            self._family_mod.paged_insert_prefill(
                self._cache, k_all, v_all, self._page_ids(b),
                self._pool.page_size)
        else:
            row_cache = self._family_mod.cb_prefill(
                self.cfg, self.params, row, self.max_len)
            self._family_mod.insert_cache_row(self._cache, row_cache, b)
        if self.draft is not None:
            # The draft's row prefills the same prompt; its first query
            # (cur at pos) writes position pos inside the round.
            draft_row = self._draft_family.cb_prefill(
                self._draft_cfg, self._draft_params, row, self.max_len)
            self._draft_family.insert_cache_row(self._draft_cache,
                                                draft_row, b)

    def _op(self, name: str, *args):
        """A pool op of ``serving/gang.py``'s ``OPS``, on every rank of a
        gang."""
        if self._gang is not None:
            return self._gang.call(f"op:{name}", *args)
        return OPS[name](*args)

    def _copy_page(self, src: int, dst: int) -> None:
        self._op("copy_page", self._cache, src, dst)

    def _page_ids(self, row: int) -> torch.Tensor:
        return torch.as_tensor(self._pool.padded_row(row), dtype=torch.long,
                               device=self.device)

    def _suffix_prefill(self, row: int, tokens, n_pref: int,
                        m: int) -> None:
        """Compute KV for ``tokens`` at absolute positions m.. of block-
        table row ``row``, attending the first ``n_pref`` prefix pages
        (columns past m are masked). The tokens are padded to their
        power-of-two bucket; padded positions write the scratch page."""
        ps = self._pool.page_size
        padded = np.zeros(bucket_suffix_len(len(tokens)), np.int64)
        padded[:len(tokens)] = tokens
        page_ids = self._page_ids(row)
        pref = page_ids[:n_pref].clamp(min=0)
        kp, vp = self._op("prefix_pages", self._cache, pref)
        k_suf, v_suf = self._family_mod.paged_prefill_suffix_kv(
            self.cfg, self.params,
            torch.as_tensor(padded[None], device=self.device), kp, vp, m)
        self._family_mod.paged_insert_suffix(
            self._cache, k_suf, v_suf, page_ids, m, ps,
            real_len=len(tokens))

    # ------------------------------------------------------ prefill lane
    def _admit_lane(self) -> None:
        """Disaggregated admission: queued requests land on free
        prefill-lane rows. The pool admission is the classic one (radix
        match, page adoption, CoW fork, fresh leaf) but no prefill runs
        here: the lane tick streams the novel suffix in chunks and the
        handoff moves the finished row."""
        for p in range(self.slots, self.slots + self.prefill_slots):
            if p in self._lane:
                continue
            picked = self._dequeue_for(p)
            if picked is None:
                break
            req, admit_res = picked
            try:
                pos0, tok0, prefill_tokens = self._family_mod.cb_admission(
                    req.tokens)
                skip = self._note_prefix_outcome(
                    req, admit_res, len(prefill_tokens or ()))
                if admit_res.cow is not None:
                    self._copy_page(*admit_res.cow)
                toks = np.asarray(prefill_tokens or [], np.int64)
                skip = min(skip, len(toks))
                if req.trace is not None:
                    req.trace.start_phase(
                        "prefill",
                        mode="cached" if skip >= len(toks) else "lane",
                        prompt_tokens=int(len(toks)), cached_tokens=skip,
                        slot=p)
                self._lane[p] = [req, toks, skip, pos0, tok0]
            except Exception as exc:  # noqa: BLE001 — request-scoped
                if not self._fail_admission(p, req, exc):
                    return

    def _drop_lane_reservation(self, p: int, error: str) -> None:
        """Abort one staged reservation: pages freed and the fresh radix
        leaf detached (its content was never fully written)."""
        req = self._lane.pop(p)[0]
        self._pool.release(p, invalidate_prefix=True)
        if not req.done.is_set():
            if error != "cancelled" or not req.error:
                req.error = error
            self._finish_trace(req)
            req.done.set()

    def _lane_tick(self, decode_live: int) -> bool:
        """Advance the prefill lane: at most ``prefill_lane_budget`` chunk
        prefills while decode rows are live, every staged reservation
        when the decode lane is idle. Returns False when fail-fast
        stopped the engine."""
        budget = (len(self._lane) if decode_live == 0
                  else self.prefill_lane_budget)
        ran = 0
        for p in list(self._lane):
            if ran >= budget:
                break
            state = self._lane[p]
            req, toks, i, pos0, tok0 = state
            if req.cancelled:
                self._drop_lane_reservation(p, "cancelled")
                continue
            if i >= len(toks):
                continue  # staged, waiting for a free decode slot
            chunk = toks[i:i + self._lane_chunk]
            try:
                self._suffix_prefill(
                    p, chunk, self._bucket_pages(-(-i // self._pool.page_size)),
                    int(i))
            except Exception as exc:  # noqa: BLE001 — request-scoped
                logger.exception("prefill lane chunk failed")
                self._drop_lane_reservation(
                    p, f"{type(exc).__name__}: {exc}")
                obs_metrics.serving_admissions_total(self._obs).inc(
                    outcome="failed")
                if not self._count_request_failure(exc):
                    return False
                continue
            ran += 1
            state[2] = i + len(chunk)
            if req.trace is not None:
                req.trace.event("chunk", pos=int(i), of=int(len(toks)))
        if ran:
            obs_metrics.serving_lane_ticks_total(self._obs).inc(
                lane="prefill")
        return True

    def _bucket_pages(self, n: int) -> int:
        """A prefix-page count bucketed to the next power of two (capped
        at the row width), as the JAX package buckets it to share
        programs; the extra pages gather the scratch page and the suffix
        mask hides every prefix column past the match depth."""
        if n <= 0:
            return 0
        return min(1 << (n - 1).bit_length(), self._pool.max_pages_per_row)

    def _lane_handoff(self) -> None:
        """Move finished reservations to free decode slots: commit the
        fresh radix leaf, transfer the row (``PagePool.handoff``) and go
        live. An unfinished reservation does not block a finished
        sibling."""
        for p in list(self._lane):
            state = self._lane[p]
            req, toks, i, pos0, tok0 = state
            if req.cancelled:
                self._drop_lane_reservation(p, "cancelled")
                continue
            if i < len(toks):
                continue
            b = next((s for s in range(self.slots)
                      if self._slot_req[s] is None), None)
            if b is None:
                return  # decode pool full: staged rows wait in place
            self._pool.commit_prefix(p)
            moved = self._pool.handoff(p, b)
            del self._lane[p]
            self._handoffs += 1
            self._handoff_pages += moved
            obs_metrics.serving_handoff_pages_total(self._obs).inc(moved)
            if req.trace is not None:
                req.trace.event("handoff", src_row=p, dst_slot=b,
                                pages=moved)
            self._go_live(b, req, pos0, tok0)

    def _lane_view(self) -> LaneView:
        """Pressure snapshot for the speculation policy: prefill backlog
        (queued, chunked reservations, lane reservations), free decode
        slots, and the oldest queued request's wait."""
        with self._cv:
            backlog = (self._queue_depth() + len(self._prefilling)
                       + len(self._lane))
            head = self._queue_head()
            oldest = (time.time() - head.submitted_at
                      if head is not None else 0.0)
        free = sum(1 for b in range(self.slots)
                   if self._slot_req[b] is None
                   and b not in self._prefilling)
        return LaneView(prefill_backlog=backlog, decode_free=free,
                        oldest_wait=oldest)

    # ----------------------------------------------------- slot lifecycle
    def _go_live(self, b: int, req: _Request, pos0: int, tok0: int) -> None:
        """Mark a slot live for decode (monolithic admission, chunked-
        prefill completion and lane handoff all land here)."""
        obs_metrics.serving_admissions_total(self._obs).inc(
            outcome="admitted")
        if req.trace is not None:
            req.trace.start_phase("decode", slot=b, pos0=int(pos0))
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
        """Persistent device breakage: fail live slots, reservations and
        the queue, then stop the engine."""
        logger.error("%d consecutive device failures; draining queue and "
                     "stopping engine", self._consec_step_failures)
        for b in range(self.slots):
            if self._slot_req[b] is not None:
                self._slot_req[b].error = f"engine failed: {err}"
                self._retire(b)
        for b, state in list(self._prefilling.items()):
            req = state[0]
            del self._prefilling[b]
            if not req.done.is_set():
                req.error = f"engine failed: {err}"
                self._finish_trace(req)
                req.done.set()
        for p in list(self._lane):
            self._drop_lane_reservation(p, f"engine failed: {err}")
        with self._cv:
            self._stopped = True
            for q in self._queues.values():
                while q:
                    req = q.popleft()
                    if not req.done.is_set():
                        req.error = f"engine failed: {err}"
                        self._finish_trace(req)
                        req.done.set()

    def _advance_prefill(self, all_slots: bool = False) -> bool:
        """Advance chunked reservations by one chunk each: the oldest
        only while live rows decode, every one when the pool is
        otherwise idle. Returns False when fail-fast stopped the
        engine."""
        c = self.prefill_chunk
        advanced = False
        for b in list(self._prefilling):
            state = self._prefilling[b]
            req = state[0]
            if req.cancelled:
                del self._prefilling[b]
                if not req.done.is_set():
                    req.error = "cancelled"
                    self._finish_trace(req)
                    req.done.set()
                continue
            if advanced and not all_slots:
                break
            req, pending, i, row_t, row_d, pos0, tok0 = state
            chunk = np.zeros(c, np.int64)  # padded tail: junk writes at
            part = pending[i:i + c]        # positions decode rewrites 1st
            chunk[:len(part)] = part
            tokens = torch.as_tensor(chunk[None], device=self.device)
            p0 = torch.tensor([i], dtype=torch.long, device=self.device)
            try:
                self._family_mod.decode_chunk(self.cfg, self.params, row_t,
                                              tokens, p0)
                if row_d is not None:
                    self._draft_family.decode_chunk(
                        self._draft_cfg, self._draft_params, row_d,
                        tokens, p0)
            except Exception as exc:  # noqa: BLE001 — request-scoped
                logger.exception("chunked prefill failed")
                del self._prefilling[b]
                obs_metrics.serving_admissions_total(self._obs).inc(
                    outcome="failed")
                req.error = f"{type(exc).__name__}: {exc}"
                self._finish_trace(req)
                req.done.set()
                if not self._count_request_failure(exc):
                    return False
                continue
            advanced = True
            state[2] = i + c
            if req.trace is not None:
                req.trace.event("chunk", pos=int(i), of=int(len(pending)))
            if state[2] >= len(pending):
                # Caught up: insert the finished row(s) and go live.
                del self._prefilling[b]
                self._family_mod.insert_cache_row(self._cache, row_t, b)
                if row_d is not None:
                    self._draft_family.insert_cache_row(
                        self._draft_cache, row_d, b)
                self._go_live(b, req, pos0, tok0)
        return True

    def _handle_step_failure(self, exc: Exception, what: str) -> bool:
        """Fail every live request with the error, drop lane
        reservations, count toward the fail-fast budget, and rebuild the
        caches (a failed step may have written part of them). Returns
        False when fail-fast stopped the engine. Called from an
        ``except`` block."""
        logger.exception("%s failed", what)
        self._step_failures += 1
        self._consec_step_failures += 1
        err = f"{type(exc).__name__}: {exc}"
        for b in range(self.slots):
            if self._slot_req[b] is not None:
                self._slot_req[b].error = err
                self._retire(b)
        for p in list(self._lane):
            self._drop_lane_reservation(p, err)
        if self._consec_step_failures >= self.max_step_failures:
            self._fail_fast(err)
            return False
        self._cache = self._new_cache()
        if self._pool is not None:
            self._pool.invalidate_prefix_cache()  # resident pages are 0
        if self.draft is not None:
            self._draft_cache = self._draft_family.cb_init_cache(
                self._draft_cfg, self.slots, self.max_len,
                device=self.device)
        return True

    def _observe_first_token(self, req: _Request) -> None:
        """TTFT (submit → first token: queue wait and prefill count) and
        the timeline annotation."""
        req.first_token_at = time.time()
        obs_metrics.serving_ttft_hist(self._obs).observe(
            req.first_token_at - req.submitted_at, **{"class": req.klass})
        if req.trace is not None:
            req.trace.event("first_token")

    def _finish_trace(self, req: _Request) -> None:
        """Close a request's span tree (idempotent)."""
        if req.trace is None:
            return
        if req.error:
            req.trace.finish(status="error", error=req.error,
                             tokens_out=len(req.out),
                             prefix_cached_tokens=req.prefix_cached_tokens)
        else:
            req.trace.finish(tokens_out=len(req.out),
                             prefix_cached_tokens=req.prefix_cached_tokens)

    def _retire(self, b: int) -> None:
        req = self._slot_req[b]
        self._slot_req[b] = None
        self._pos[b] = -1
        self._gens[b] = None
        if self._pool is not None:
            self._pool.release(b)
        if req is not None:
            if req.cancelled and not req.error:
                req.error = "cancelled"
            if not req.error:
                self._served += 1
                self._tokens_out += len(req.out)
            now = time.time()
            obs_metrics.serving_request_hist(self._obs).observe(
                now - req.submitted_at)
            if (not req.error and req.first_token_at is not None
                    and len(req.out) >= 2):
                # TPOT excludes the first token (TTFT's job).
                obs_metrics.serving_tpot_hist(self._obs).observe(
                    (now - req.first_token_at) / (len(req.out) - 1),
                    **{"class": req.klass})
            self._publish_queue_depth()
            self._finish_trace(req)
            req.done.set()

    # ------------------------------------------------------- preemption
    def _maybe_preempt(self) -> None:
        """Evict one live lower-priority slot for blocked urgent work, at
        most one per tick: when pending ``preempts``-class requests
        outnumber the free slot (or lane) entries, or the pool cannot
        admit the oldest one's prompt. The victim is a live slot of a
        preemptible class with strictly lower priority, the one holding
        the most pages first. Its pages release through the retire path,
        so its committed prefix stays in the radix tree and its
        re-admission is a suffix-only prefill."""
        if (self._pool is None or not self.class_admission
                or not self.preemption):
            return
        with self._cv:
            cand = None
            demand = 0
            for name, q in self._queues.items():
                if not q or not resolve_request_class(name).preempts:
                    continue
                demand += len(q)
                if cand is None or q[0].seq < cand[0].seq:
                    cand = (q[0], resolve_request_class(name))
        if cand is None:
            return
        req, rc = cand
        if self.prefill_slots:
            free = sum(1 for p in range(self.slots,
                                        self.slots + self.prefill_slots)
                       if p not in self._lane)
        else:
            free = sum(1 for b in range(self.slots)
                       if self._slot_req[b] is None
                       and b not in self._prefilling)
        fits = self._pool.can_admit(len(req.tokens), req.tokens)
        if free >= demand and fits:
            return  # capacity absorbs every urgent pending request
        victim = self._pick_victim(rc.priority)
        if victim is None:
            return
        self._evict_slot(victim, reason="kv_pages" if free else "slots")

    def _pick_victim(self, min_priority: int) -> Optional[int]:
        """The decode slot to evict for a blocked class of
        ``min_priority``: preemptible, strictly lower priority, most pages
        held first, fewest emitted tokens as tiebreak. Lane reservations
        are never victims."""
        best = None  # ((-priority, pages, -emitted), slot)
        for b in range(self.slots):
            victim = self._slot_req[b]
            if victim is None or b in self._prefilling:
                continue
            vrc = resolve_request_class(victim.klass)
            if not vrc.preemptible or vrc.priority >= min_priority:
                continue
            key = (-vrc.priority, self._pool.slot_pages(b),
                   -len(victim.out))
            if best is None or key > best[0]:
                best = (key, b)
        return best[1] if best is not None else None

    def _evict_slot(self, b: int, reason: str) -> None:
        """Evict slot ``b`` and requeue its request at the head of its
        class queue. Emitted tokens are discarded and regenerated on
        resume (greedy argmax, or the request's seed from its start), so
        a streaming client sees a consistent prefix; TTFT re-observes at
        the retry's first token."""
        req = self._slot_req[b]
        rc = resolve_request_class(req.klass)
        held = self._pool.slot_pages(b)
        discarded = len(req.out)
        self._slot_req[b] = None
        self._pos[b] = -1
        self._gens[b] = None
        self._pool.release(b)
        req.preemptions += 1
        req.out.clear()
        req.first_token_at = None
        self._preemptions[rc.name] = self._preemptions.get(rc.name, 0) + 1
        obs_metrics.serving_preemptions_total(self._obs).inc(
            **{"class": rc.name, "reason": reason})
        if req.trace is not None:
            req.trace.event("preempted", reason=reason, slot=b,
                            pages_held=held, tokens_discarded=discarded)
            req.trace.start_phase("queue_wait", requeued=True)
        with self._cv:
            self._queue_for(req).appendleft(req)
            self._publish_queue_depth()

    # -------------------------------------------------------------- loop
    def _loop(self) -> None:
        with torch.no_grad():
            while True:
                with self._cv:
                    while (not self._stopped and not self._queue_depth()
                           and not self._prefilling and not self._lane
                           and all(r is None for r in self._slot_req)):
                        self._cv.wait()
                    if self._stopped:
                        return
                # Idle waiting is excluded from the tick duration.
                t0 = time.time()
                if not self._tick():
                    return
                self._observe_tick(time.time() - t0)

    def _observe_tick(self, dt: float) -> None:
        """Tick duration plus the batch-composition and KV-page gauges."""
        obs_metrics.serving_tick_hist(self._obs).observe(dt)
        decode = sum(1 for r in self._slot_req if r is not None)
        prefill = len(self._prefilling) + len(self._lane)
        slots = obs_metrics.serving_batch_slots(self._obs)
        slots.set(decode, state="decode")
        slots.set(prefill, state="prefill")
        slots.set(max(self.slots - decode - len(self._prefilling), 0),
                  state="free")
        if self._pool is not None:
            util = self._pool.utilization()
            pages = obs_metrics.serving_kv_pages(self._obs)
            pages.set(util["used"], state="used")
            pages.set(util["free"], state="free")
            radix = self._pool.radix_stats()
            obs_metrics.serving_radix_nodes(self._obs).set(radix["nodes"])
            rpages = obs_metrics.serving_radix_pages(self._obs)
            rpages.set(radix["referenced"], state="referenced")
            rpages.set(radix["resident"], state="resident")

    def _tick(self) -> bool:
        """One engine iteration. Classic: drop cancellations, preempt,
        admit, advance chunked prefills, then one decode step or
        speculative round. With prefill lanes: hand finished lane rows
        off, admit into lane rows, run the budgeted lane chunks, hand off
        again, then give the decode lane its budgeted steps. Returns
        False when fail-fast stopped the engine."""
        for b in range(self.slots):
            req = self._slot_req[b]
            if req is not None and req.cancelled:
                self._retire(b)
        self._maybe_preempt()
        if self.prefill_slots:
            self._lane_handoff()
            self._admit_lane()
        else:
            self._admit()
        if self._stopped:  # admission may fail-fast mid-pass
            return False
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     self._queue_depth())
        live = sum(1 for r in self._slot_req if r is not None)
        if self._lane:
            if not self._lane_tick(live):
                return False
            self._lane_handoff()
            live = sum(1 for r in self._slot_req if r is not None)
        elif self._prefilling:
            if not self._advance_prefill(all_slots=(live == 0)):
                return False
            live = sum(1 for r in self._slot_req if r is not None)
        if live == 0:
            self._last_decode_at = None
            return True
        if self.prefill_slots and self.decode_lane_budget < 1:
            # A zeroed decode budget is honored (the lane-starve drill):
            # staged work goes live and then emits nothing.
            self._last_decode_at = None
            time.sleep(0.005)
            return True
        obs_metrics.serving_lane_ticks_total(self._obs).inc(lane="decode")
        steps = self.decode_lane_budget if self.prefill_slots else 1
        for _ in range(max(steps, 1)):
            live = sum(1 for r in self._slot_req if r is not None)
            if live == 0:
                break
            self._steps_total += 1
            self._live_slot_steps += live
            if self.draft is not None:
                k = max(0, min(
                    self._spec_policy.draft_len(self._lane_view()),
                    self.spec_k))
                obs_metrics.serving_spec_draft_len(self._obs).set(k)
                if k > 0:
                    if not self._spec_iteration(k):
                        return False
                    self._note_decode_step()
                    continue
                # No headroom: a plain step (lossless either way; the
                # draft cache accrues holes that lower acceptance).
            if not self._plain_step():
                return False
            self._note_decode_step()
        return True

    def _note_decode_step(self) -> None:
        """The wall gap between consecutive decode-lane steps (idle gaps
        never count)."""
        now = time.monotonic()
        if self._last_decode_at is not None:
            obs_metrics.serving_decode_tpot_hist(self._obs).observe(
                now - self._last_decode_at)
        self._last_decode_at = now

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

    def _decode_logits(self) -> torch.Tensor:
        """One decode step of the decode pool's rows (lane rows sit past
        ``slots`` and belong to staged prefills)."""
        tokens = torch.as_tensor(self._cur, device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        if self._pool is None:
            logits, self._cache = self._family_mod.decode_step_ragged(
                self.cfg, self.params, self._cache, tokens, pos)
        else:
            logits, self._cache = self._family_mod.decode_step_paged(
                self.cfg, self.params, self._cache, tokens, pos,
                torch.as_tensor(self._pool.tables[:self.slots],
                                dtype=torch.long, device=self.device))
        return logits

    def _plain_step(self) -> bool:
        """One decode step for every slot. Returns False when fail-fast
        stopped the engine."""
        t0 = time.perf_counter()
        try:
            nxt = self._sample(self._decode_logits())
        except Exception as exc:  # noqa: BLE001 — fail live requests
            return self._handle_step_failure(exc, "decode step")
        self._step_seconds.append(time.perf_counter() - t0)
        self._consec_step_failures = 0
        for b in range(self.slots):
            req = self._slot_req[b]
            if req is None:
                continue
            tok = int(nxt[b])
            req.out.append(tok)
            if req.first_token_at is None:
                self._observe_first_token(req)
            self._pos[b] += 1
            self._cur[b] = tok
            if len(req.out) >= req.max_new or tok in req.eos:
                self._retire(b)
            elif (self._pool is not None
                  and not self._pool.ensure(b, int(self._pos[b]))):
                # An oversubscribed pool ran dry mid-generation: fail THIS
                # row loudly rather than let it write a neighbour's pages.
                obs_metrics.serving_evictions_total(self._obs).inc(
                    reason="pool_exhausted")
                if req.trace is not None:
                    req.trace.event("evicted", reason="pool_exhausted",
                                    pos=int(self._pos[b]))
                req.error = (
                    "kv page pool exhausted mid-generation "
                    f"(pos {int(self._pos[b])}); raise --kv-pages "
                    "or lower concurrency")
                self._retire(b)
        return True

    def _spec_round(self, k: int, budget: np.ndarray):
        """One draft→verify round for the whole pool: (target tokens
        [B, k+1], emitted count [B], next current token [B]). Idle rows
        run at clamped positions and emit 0; their rows are replaced
        wholesale by the next admission's insert."""
        dev = self.device
        cur = torch.as_tensor(self._cur, device=dev)
        pos = torch.as_tensor(self._pos, device=dev)
        rows = torch.arange(self.slots, device=dev)
        live = pos >= 0
        p0 = pos.clamp(min=0)
        # k+1 draft steps for k proposals: the extra step writes the last
        # proposal's draft KV (the hole-free invariant of speculative.py).
        tok, p, drafts = cur, p0, []
        for _ in range(k + 1):
            lg, self._draft_cache = self._draft_family.decode_step_ragged(
                self._draft_cfg, self._draft_params, self._draft_cache,
                tok, p)
            tok = lg.argmax(dim=-1)
            drafts.append(tok)
            p = p + 1
        d = torch.stack(drafts[:k], dim=1)
        chunk = torch.cat([cur[:, None], d], dim=1)
        logits, self._cache = self._family_mod.decode_chunk(
            self.cfg, self.params, self._cache, chunk, p0)
        t = logits.argmax(dim=-1)
        accepted = torch.cumprod((d == t[:, :k]).long(), dim=1).sum(dim=1)
        emit = torch.minimum(accepted + 1,
                             torch.as_tensor(budget, device=dev))
        emit = torch.where(live, emit, torch.zeros_like(emit))
        cur_nxt = torch.where(emit > 0, t[rows, (emit - 1).clamp(min=0)],
                              cur)
        return t.cpu().numpy(), emit.cpu().numpy(), cur_nxt.cpu().numpy()

    def _spec_iteration(self, k: Optional[int] = None) -> bool:
        """One draft→verify round: every live slot emits 1..k+1 tokens
        (ragged acceptance, per-row budget caps). Returns False when a
        persistent failure stopped the engine."""
        k = self.spec_k if k is None else k
        budget = np.zeros(self.slots, np.int64)
        for b in range(self.slots):
            req = self._slot_req[b]
            if req is not None:
                budget[b] = req.max_new - len(req.out)
        t0 = time.perf_counter()
        try:
            t, emit, cur_nxt = self._spec_round(k, budget)
        except Exception as exc:  # noqa: BLE001 — fail live requests
            return self._handle_step_failure(exc, "speculative round")
        self._step_seconds.append(time.perf_counter() - t0)
        self._consec_step_failures = 0
        self._spec_rounds += 1
        for b in range(self.slots):
            req = self._slot_req[b]
            if req is None:
                continue
            n = int(emit[b])
            self._spec_tokens += n
            # Of the k proposals this row verified, emit-1 were the
            # draft's (the last emitted token is the target's own).
            self._spec_proposed += k
            self._spec_accepted += max(n - 1, 0)
            fresh = [int(tok) for tok in t[b, :n]]
            hit = next((j for j, tok in enumerate(fresh)
                        if tok in req.eos), None)
            if hit is not None:
                fresh = fresh[:hit + 1]  # stop at the eos, inclusive
            req.out.extend(fresh)
            if fresh:
                if req.first_token_at is None:
                    self._observe_first_token(req)
                if req.trace is not None:
                    req.trace.event("spec_round", accepted=n,
                                    emitted=len(fresh))
            self._pos[b] += n
            self._cur[b] = int(cur_nxt[b])
            if len(req.out) >= req.max_new or hit is not None:
                self._retire(b)
        return True
