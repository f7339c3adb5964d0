"""Sharded serving over a gang of ranks: one process per card, one HTTP
server.

The JAX package serves one process over a device mesh, and GSPMD puts
the collectives into each compiled step. Here each rank of a process
group holds its shards of the weights (``serving/server.py load_params``
with a mesh) and its own KV pool, and the ranks run every model call
together:

- rank 0 owns everything that decides: the HTTP server and the engine
  (``_Engine``, or ``ContinuousBatchingEngine`` with its slots, pages,
  prefix cache, lanes, classes, preemption and speculation). The engine
  reaches the model only through its family module and its few engine
  ops (``OPS``), and a ``Gang`` stands in for both: a call goes to every
  rank through ``Gang.call``, one ``broadcast_object_list`` of the
  call's name and inputs (token ids, positions, block tables, page ids:
  host-sized tensors), then every rank runs it on its shards;
- the other ranks run ``Gang.follow`` until rank 0 stops the server.

Objects a call returns that stay on their rank (a KV pool, a prefilled
row's K/V, logits) are named by a handle that every rank assigns alike
(the call's number and the object's place in the result); a later call
that passes one back passes its handle, and each rank substitutes its
own object. Rank 0 notices when its engine drops one (a weak reference)
and the next call tells the other ranks to drop theirs. The model's
parameters pass as a marker: each rank substitutes its view of its own
shards (``parallel/fsdp.py serving_view``: tp and ep shards computed
where they are, fsdp shards gathered at use).

Every rank computes the same rows: the batch is replicated over every
axis (``parallel/mesh.py replicated_rows``: a MoE over ep runs each
rank's experts on all of them and sums their parts), the logits come
out whole on every rank (a vocab-parallel head is gathered over tp),
and rank 0 samples. On a mesh of one rank no gang is built and the
engine calls the family directly.
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from polyaxon_tpu_torch.parallel.mesh import replicated_rows, use_mesh

logger = logging.getLogger(__name__)

# The family functions that run the model or touch a KV pool: every rank
# runs them. The rest of a family's surface (admission rules, budget
# checks, configs) is plain data and runs on rank 0 alone.
MODEL_CALLS = frozenset({
    "paged_init_cache", "cb_init_cache", "init_cache", "init_decoder_cache",
    "paged_prefill_kv", "paged_insert_prefill", "paged_prefill_suffix_kv",
    "paged_insert_suffix", "cb_prefill", "insert_cache_row", "prefill",
    "decode_step", "decode_step_ragged", "decode_step_paged", "decode_chunk",
    "generate", "encode", "precompute_cross_kv"})

# Handles per call: a call's n-th returned object is (call << _SHIFT) + n.
_SHIFT = 16


def copy_page(cache: dict, src: int, dst: int) -> dict:
    """Copy page ``src`` of a paged pool onto page ``dst``, in place (a
    copy-on-write fork)."""
    for arr in cache.values():
        arr[:, dst] = arr[:, src]
    return cache


def prefix_pages(cache: dict, pages: torch.Tensor):
    """The K/V of ``pages`` of a paged pool in chain order,
    [L, n·page, KV, Hd] each (a suffix prefill's prefix)."""
    return (cache["k"][:, pages].flatten(1, 2),
            cache["v"][:, pages].flatten(1, 2))


# Engine ops on a KV pool, run on every rank like a family function.
OPS: dict[str, Callable] = {"copy_page": copy_page,
                            "prefix_pages": prefix_pages}


class ParamsRef:
    """The marker an engine holds for the weights of ``role`` ("target" or
    "draft"): every rank substitutes its own view."""

    def __init__(self, role: str):
        self.role = role

    def __repr__(self) -> str:
        return f"ParamsRef({self.role!r})"


class _Handle(dict):
    """A dict result kept under a handle (rank 0 refers to it weakly,
    which a plain dict does not allow)."""

    __slots__ = ("__weakref__",)


class _Family:
    """A family module as the engine sees it under a gang: the model
    calls go to every rank, the rest is the module's own."""

    def __init__(self, gang: "Gang", role: str, module):
        self._gang, self._role, self._module = gang, role, module
        self.__name__ = module.__name__

    def __getattr__(self, name: str):
        value = getattr(self._module, name)
        if name in MODEL_CALLS:
            return lambda *a, **k: self._gang.call(f"{self._role}:{name}",
                                                   *a, **k)
        return value


class Worker:
    """What a rank serves: per role, the family module, its config, its
    pieces of the weights and the view of them a model call computes
    with (``view()``)."""

    def __init__(self):
        self.roles: dict[str, tuple] = {}

    def add(self, role: str, family, cfg, params,
            view: Callable[[], Any]) -> None:
        self.roles[role] = (family, cfg, params, view)


class Gang:
    """The ranks of one sharded server (module docstring). ``mesh`` spans
    every rank of the default process group; ``worker`` is this rank's
    ``Worker``."""

    def __init__(self, mesh, worker: Worker, device):
        self.mesh = mesh
        self.worker = worker
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.calls = 0            # model calls run (every rank counts)
        self._objs: dict[int, Any] = {}   # followers: handle -> object
        self._ids: dict[int, int] = {}    # id(object) -> handle
        self._released: list[int] = []
        self._lock = threading.Lock()
        self._stopped = False

    # ------------------------------------------------------------ rank 0
    def family(self, role: str, module) -> _Family:
        return _Family(self, role, module)

    def call(self, fn: str, *args, **kwargs):
        """Run ``fn`` (``role:function`` or ``op:name``) on every rank;
        rank 0's result."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("the serving gang has stopped")
            released, self._released = self._released, []
            tensors: list[torch.Tensor] = []
            wire = (fn, self._encode(args, tensors),
                    self._encode(kwargs, tensors),
                    [t.detach().cpu() for t in tensors], released,
                    self.calls)
            dist.broadcast_object_list([wire], src=0)
            return self._run(fn, args, kwargs, self.calls)

    def stop(self) -> None:
        """Release the other ranks from ``follow``."""
        with self._lock:
            if not self._stopped:
                self._stopped = True
                dist.broadcast_object_list([None], src=0)

    def _encode(self, value, tensors: list):
        if isinstance(value, ParamsRef):
            return ("params", value.role)
        handle = self._ids.get(id(value))
        if handle is not None:
            return ("handle", handle)
        if isinstance(value, torch.Tensor):
            tensors.append(value)
            return ("tensor", len(tensors) - 1)
        if isinstance(value, torch.Generator):
            return ("generator", value.device.type, value.get_state())
        if isinstance(value, (list, tuple)):
            return (type(value).__name__,
                    [self._encode(v, tensors) for v in value])
        if isinstance(value, dict):
            return ("dict", {k: self._encode(v, tensors)
                             for k, v in value.items()})
        return ("value", value)

    def _release(self, handle: int, key: int) -> None:
        self._ids.pop(key, None)
        self._released.append(handle)

    # ---------------------------------------------------------- followers
    def follow(self) -> None:
        """Run rank 0's calls until it stops the server."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            if box[0] is None:
                return
            fn, args, kwargs, tensors, released, number = box[0]
            for handle in released:
                obj = self._objs.pop(handle, None)
                self._ids.pop(id(obj), None)
            tensors = [t.to(self.device) for t in tensors]
            try:
                self._run(fn, self._decode(args, tensors),
                          self._decode(kwargs, tensors), number)
            except Exception:  # noqa: BLE001 — rank 0 raises it too
                logger.exception("serving gang call %s failed", fn)

    def _decode(self, value, tensors: list):
        kind, body = value[0], value[1]
        if kind == "params":
            return ParamsRef(body)
        if kind == "handle":
            return self._objs[body]
        if kind == "tensor":
            return tensors[body]
        if kind == "generator":
            gen = torch.Generator(device=self.device if body == "cuda"
                                  else "cpu")
            gen.set_state(value[2])
            return gen
        if kind in ("list", "tuple"):
            items = [self._decode(v, tensors) for v in body]
            return items if kind == "list" else tuple(items)
        if kind == "dict":
            return {k: self._decode(v, tensors) for k, v in body.items()}
        return body

    # -------------------------------------------------------- every rank
    def _run(self, fn: str, args, kwargs, number: int):
        role, name = fn.split(":", 1)
        with use_mesh(self.mesh), replicated_rows(), torch.no_grad():
            args, kwargs = self._bind(args), self._bind(kwargs)
            out = (OPS[name](*args, **kwargs) if role == "op"
                   else getattr(self.worker.roles[role][0], name)(
                       *args, **kwargs))
        self.calls += 1
        return self._keep(out, [number << _SHIFT])

    def _bind(self, value):
        """The rank's own weights in place of each ``ParamsRef``."""
        if isinstance(value, ParamsRef):
            return self.worker.roles[value.role][3]()
        if isinstance(value, (list, tuple)):
            return type(value)(self._bind(v) for v in value)
        if isinstance(value, dict) and not isinstance(value, _Handle):
            return {k: self._bind(v) for k, v in value.items()}
        return value

    def _keep(self, out, counter: list):
        """Give ``out``'s rank-local objects their handles (in one order
        on every rank): tensors and dicts, inside tuples and lists."""
        if isinstance(out, (tuple, list)):
            return type(out)(self._keep(v, counter) for v in out)
        if not isinstance(out, (torch.Tensor, dict)):
            return out
        if id(out) in self._ids:  # a pool passed in and returned
            return out
        handle = counter[0]
        counter[0] += 1
        if isinstance(out, dict):
            out = _Handle(out)
        self._ids[id(out)] = handle
        if self.rank == 0:
            weakref.finalize(out, self._release, handle, id(out))
        else:
            self._objs[handle] = out
        return out


def build_gang(mesh, worker: Worker, device) -> Optional[Gang]:
    """A ``Gang`` over ``mesh``, or None on a mesh of one rank (the
    engine then calls its family directly)."""
    return None if mesh is None or mesh.size == 1 else Gang(mesh, worker,
                                                             device)
