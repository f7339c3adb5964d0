"""Every pair of mesh axes in the port's training, held against the JAX
package's train step in gloo gangs on the CPU (``tests/torch_pairs.py``:
three adamw steps a case, losses and the first grad norm to rel 1e-5,
every leaf's first reduced gradient to rel 1e-4, each gradient reduced
at most once per axis); MoE's pairs are
``tests/test_torch_axis_pairs_moe.py``'s.

- llama_tiny (4 layers, 2 stages, 2 microbatches) at pp2 x fsdp2 x dp2,
  pp2 x tp2 x dp2, pp2 x cp2 (ring) and pp2 x sp2, and at tp2 x cp2
  (ring; ``CP_RULES`` leaves the query heads whole over tp, and each tp
  rank computes on its share of them), there with LoRA adapters on the
  projections too (only the adapters train; their gradients compared);
- t5_tiny, bert_tiny and vit_tiny at dp2 x cp2: rows replicated over cp
  (vit at 24-pixel images, whose 10 positions split over cp; at its
  32-pixel default both packages refuse to place the 17 positions).

The reference cannot run llama's pipeline beside a cp axis on its CPU
mesh (its ring's ``shard_map`` inside the pipeline's fails: ROADMAP.md,
Queue 3), so pp2 x cp2 is held against its step over the mesh's batch
axes alone (none: one device, unpipelined, einsum attention), which
computes the same function.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from tests import torch_jax_ref as ref
from tests import torch_pairs as pairs

PIPE = {"n_layers": 4, "pipeline_stages": 2, "pipeline_microbatches": 2}
RING = {"attention_impl": "ring"}
# name: (model, overrides, port axes, the reference's axes and overrides
# where its step cannot run the port's mesh)
CASES = {
    "llama-pp2xfsdp2xdp2": ("llama_tiny", PIPE, {"dp": 2, "pp": 2,
                                                 "fsdp": 2}, None),
    "llama-pp2xtp2xdp2": ("llama_tiny", PIPE, {"dp": 2, "pp": 2, "tp": 2},
                          None),
    "llama-pp2xcp2": ("llama_tiny", {**PIPE, **RING}, {"pp": 2, "cp": 2},
                      ({"dp": 1}, {"n_layers": 4})),
    "llama-pp2xsp2": ("llama_tiny", PIPE, {"pp": 2, "sp": 2}, None),
    "llama-tp2xcp2": ("llama_tiny", {"n_layers": 4, **RING},
                      {"cp": 2, "tp": 2}, None),
    "llama_lora-tp2xcp2": ("llama_tiny", {"n_layers": 4, **RING},
                           {"cp": 2, "tp": 2}, None),
    "t5-dp2xcp2": ("t5_tiny", {}, {"dp": 2, "cp": 2}, None),
    "bert-dp2xcp2": ("bert_tiny", {}, {"dp": 2, "cp": 2}, None),
    "vit-dp2xcp2": ("vit_tiny", {"image_size": 24}, {"dp": 2, "cp": 2},
                    None),
}
# LoRA adapters over the attention and MLP projections: under tp2 x cp2
# wq and wo (whole over tp) meet their factors on each rank's tp share.
LORA = {"llama_lora-tp2xcp2": {"rank": 4, "alpha": 8.0,
                               "targets": ("wq", "wk", "wv", "wo",
                                           "w_gate", "w_up", "w_down")}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    return pairs.make_inputs(CASES, LORA)


@pytest.fixture(scope="module")
def gangs(inputs):
    """The gangs, started in threads while JAX computes."""
    pool, futures = pairs.start_gangs(CASES, (), LORA, inputs)
    yield futures
    pool.shutdown()


@pytest.fixture(scope="module")
def reference(inputs, gangs):
    return pairs.compute_reference(CASES, (), LORA, inputs)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax(name, gangs, reference):
    pairs.check_steps(name, CASES, gangs, reference)


@pytest.mark.parametrize("name", list(CASES))
def test_each_gradient_is_reduced_once_per_axis(name, gangs):
    pairs.check_reduced_once(name, CASES, gangs)


def test_vit_positions_that_do_not_split_are_refused_alike():
    """At its default 32-pixel images vit_tiny has 17 positions, which
    neither package places over cp2 (``pos_embed``'s ``seq`` axis)."""
    from polyaxon_tpu.models import get_model as jget
    from polyaxon_tpu.parallel import rules_for_mesh as jrules
    from polyaxon_tpu.parallel.sharding import tree_shardings
    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.parallel.mesh import build_mesh
    from polyaxon_tpu_torch.parallel.sharding import (leaf_shard,
                                                      rules_for_mesh,
                                                      tree_placements)

    params0 = ref.drawn_params("vit_tiny", {})
    jdef = jget("vit_tiny", dtype=jnp.float32)
    mesh = ref.jax_mesh({"dp": 2, "cp": 2})
    with pytest.raises(ValueError, match="divisible"):
        jax.device_put(params0, tree_shardings(
            jdef.logical_axes()["params"], mesh, jrules(mesh)))
    tdef = get_model("vit_tiny", dtype=torch.float32)
    tmesh = build_mesh(axes={"dp": 2, "cp": 2}, devices=range(4))
    placements = tree_placements(tdef.logical_axes()["params"], tmesh,
                                 rules_for_mesh(tmesh))
    with pytest.raises(ValueError, match="does not divide"):
        leaf_shard(params0["pos_embed"].shape, placements["pos_embed"],
                   tmesh, tmesh.coords(0), "pos_embed")
