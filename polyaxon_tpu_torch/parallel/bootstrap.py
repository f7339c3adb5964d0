"""Process-group bootstrap from the launch plan's env contract (port of
``polyaxon_tpu/parallel/bootstrap.py``).

The plan injects ``POLYAXON_TPU_COORDINATOR`` (``host:port``),
``POLYAXON_TPU_NUM_PROCESSES``, ``POLYAXON_TPU_PROCESS_ID`` and
optionally ``POLYAXON_TPU_LOCAL_DEVICE_IDS``; every process of the gang
calls ``initialize``, which starts ``torch.distributed`` over the
coordinator: NCCL on CUDA (one card per process, the first local device
id selecting it), gloo when the caller names the CPU. One process makes
a real one-rank group too, so that a single card runs the code a gang
runs. ``shutdown`` destroys a group that ``initialize`` started, so a
later run in the same process starts clean.

``process_group(device)`` is the in-process runs' form: it starts a
one-rank group when none exists and destroys it when the last run that
entered it leaves, so concurrent in-process runs (the agent's threads)
share it and none is left behind.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import socket
import threading
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from polyaxon_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

ENV_COORDINATOR = "POLYAXON_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "POLYAXON_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "POLYAXON_TPU_PROCESS_ID"
ENV_LOCAL_DEVICE_IDS = "POLYAXON_TPU_LOCAL_DEVICE_IDS"

# Collectives that wait longer than this fail instead of hanging a gang.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class ProcessGroup:
    coordinator: Optional[str]
    num_processes: int
    process_id: int
    initialized: bool

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1


def free_port() -> int:
    """A TCP port on the loopback interface that is free now (a local
    gang's coordinator)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def read_env_contract(env: Optional[dict[str, str]] = None) -> ProcessGroup:
    env = dict(os.environ if env is None else env)
    return ProcessGroup(
        coordinator=env.get(ENV_COORDINATOR),
        num_processes=int(env.get(ENV_NUM_PROCESSES, "1")),
        process_id=int(env.get(ENV_PROCESS_ID, "0")),
        initialized=False,
    )


# Held while the default group or a mesh's groups are started or
# destroyed.
group_lock = threading.RLock()
_owned = False   # the default group was started here
_users = 0       # runs inside process_group()
_shared = False  # process_group() started the default group


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(group: Optional[ProcessGroup] = None, *, device=None,
               init_method: Optional[str] = None) -> ProcessGroup:
    """Start the default process group from the env contract (or
    ``group``), idempotently: an existing group is kept. ``device``
    picks the backend (``cuda`` unless the caller names the CPU; raises
    without a GPU). A multi-process group needs the coordinator (or an
    explicit ``init_method``). The new group is checked with one
    all-reduce, so a failed NCCL start raises here."""
    global _owned
    group = group or read_env_contract()
    with group_lock:
        if dist.is_initialized():
            group.initialized = True
            return group
        if group.is_multiprocess and not group.coordinator \
                and init_method is None:
            raise RuntimeError(
                f"{ENV_NUM_PROCESSES}={group.num_processes} but "
                f"{ENV_COORDINATOR} is unset; the launch plan must inject "
                "the coordinator address")
        dev = resolve_device(device)
        kwargs: dict = {}
        if dev.type == "cuda":
            local_ids = os.environ.get(ENV_LOCAL_DEVICE_IDS)
            index = (int(local_ids.split(",")[0]) if local_ids
                     else (dev.index if dev.index is not None
                           else torch.cuda.current_device()))
            torch.cuda.set_device(index)
            dev = torch.device("cuda", index)
            backend = "nccl"
            kwargs["device_id"] = dev
        else:
            backend = "gloo"
        if init_method is None and group.is_multiprocess:
            init_method = f"tcp://{group.coordinator}"
        if init_method is None:
            # One process: an in-memory store, no port to bind.
            kwargs["store"] = dist.HashStore()
        else:
            kwargs["init_method"] = init_method
        dist.init_process_group(backend, world_size=group.num_processes,
                                rank=group.process_id, timeout=TIMEOUT,
                                **kwargs)
        _owned = True
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        if int(probe.item()) != group.num_processes:
            raise RuntimeError(
                f"process group check: all-reduce of ones gave "
                f"{probe.item()}, expected {group.num_processes}")
        logger.info("torch.distributed initialized (%s): process %d/%d via "
                    "%s", backend, group.process_id, group.num_processes,
                    group.coordinator or "an in-memory store")
        group.initialized = True
        return group


def shutdown() -> None:
    """Destroy the default group if ``initialize`` started it."""
    global _owned
    with group_lock:
        if _owned and dist.is_initialized():
            dist.destroy_process_group()
        _owned = False


@contextlib.contextmanager
def process_group(device):
    """A process group for one in-process run: the existing one (a gang's,
    started by the launcher), or a one-rank group started here and
    destroyed when the last run inside leaves."""
    global _users, _shared
    with group_lock:
        if not dist.is_initialized():
            initialize(ProcessGroup(None, 1, 0, False), device=device)
            _shared = True
        _users += 1
    try:
        yield
    finally:
        with group_lock:
            _users -= 1
            if _users == 0 and _shared:
                _shared = False
                shutdown()
