"""The parallel layer (port of ``polyaxon_tpu/parallel``): meshes, the
process bootstrap, the sharding rules, gather at use, tensor
parallelism and the pipeline schedule. Every axis and every combination
of them is placed, each axis's mechanism running inside the others'.

Three parts of the JAX package's ``perf/`` have no counterpart here:
``hlo.py`` parses XLA's HLO text, ``aot.py`` probes ahead-of-time TPU
compiles, and ``flash_tiles.json`` is the Pallas flash kernel's tile
table (the port's tiles are fixed in ``ops/csrc``). The rest of
``perf/`` (``audit.py``, ``budgets.py``, ``budgets.json``,
``__main__.py``) is a CI gate on the collectives a train step emits;
its counterpart counts this layer's ``torch.distributed`` calls per
schedule point and is still to come (ROADMAP.md, Queue 1 item 12)."""

from polyaxon_tpu_torch.parallel.bootstrap import (ProcessGroup, initialize,
                                                   read_env_contract)
from polyaxon_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    build_mesh,
    mesh_summary,
    parse_mesh_axes,
    single_device_mesh,
)
from polyaxon_tpu_torch.parallel.sharding import (
    STRATEGY_RULES,
    batch_spec,
    logical_to_spec,
    merge_rules,
    param_bytes,
    rules_for_mesh,
    tree_placements,
)

__all__ = [
    "AXIS_ORDER",
    "ProcessGroup",
    "STRATEGY_RULES",
    "batch_spec",
    "build_mesh",
    "initialize",
    "logical_to_spec",
    "merge_rules",
    "mesh_summary",
    "param_bytes",
    "parse_mesh_axes",
    "read_env_contract",
    "rules_for_mesh",
    "single_device_mesh",
    "tree_placements",
]
