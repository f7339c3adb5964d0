"""The parallel layer (port of ``polyaxon_tpu/parallel``): meshes, the
process bootstrap, the sharding rules, gather at use, tensor
parallelism and the pipeline schedule. Every axis is placed; a few
combinations of the model-parallel axes are ROADMAP.md, Queue 1 item
7d, its second half."""

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
