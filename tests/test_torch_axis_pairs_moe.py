"""MoE's axis pairs in the port's training, held against the JAX
package's train step in gloo gangs on the CPU (``tests/torch_pairs.py``:
three adamw steps a case, losses and the first grad norm to rel 1e-5,
every leaf's first reduced gradient to rel 1e-4, each gradient reduced
at most once per axis):

- moe_tiny at no-drop capacity at tp2 x ep2 (``EP_RULES`` leaves each
  expert's ``mlp`` whole over tp: each tp rank computes its share),
  fsdp2 x ep2, cp2 x ep2 and pp2 x ep2 (cp and pp replicate a family
  that neither shards sequences nor pipelines);
- its dense dispatch and its expert-choice router at dp2 x ep2 (the
  default capacity): each rank's experts on every row block's tokens,
  the slots and the experts' picks the global batch's, and their
  forward logits and router aux against the reference's forward.
"""

import pytest
import torch

from tests import torch_pairs as pairs

NO_DROP = {"capacity_factor": 8.0}
# name: (model, overrides, port axes, None: the reference runs the mesh)
CASES = {
    "moe-tp2xep2": ("moe_tiny", NO_DROP, {"ep": 2, "tp": 2}, None),
    "moe-fsdp2xep2": ("moe_tiny", NO_DROP, {"fsdp": 2, "ep": 2}, None),
    "moe-cp2xep2": ("moe_tiny", NO_DROP, {"cp": 2, "ep": 2}, None),
    "moe-pp2xep2": ("moe_tiny", NO_DROP, {"pp": 2, "ep": 2}, None),
    "moe_dense-dp2xep2": ("moe_tiny", {"dispatch": "dense"},
                          {"dp": 2, "ep": 2}, None),
    "moe_choice-dp2xep2": ("moe_tiny", {"router": "expert_choice"},
                           {"dp": 2, "ep": 2}, None),
}
FORWARD = ("moe_dense-dp2xep2", "moe_choice-dp2xep2")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    return pairs.make_inputs(CASES, {})


@pytest.fixture(scope="module")
def gangs(inputs):
    """The gang, started in a thread while JAX computes."""
    pool, futures = pairs.start_gangs(CASES, FORWARD, {}, inputs)
    yield futures
    pool.shutdown()


@pytest.fixture(scope="module")
def reference(inputs, gangs):
    return pairs.compute_reference(CASES, FORWARD, {}, inputs)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax(name, gangs, reference):
    pairs.check_steps(name, CASES, gangs, reference)


@pytest.mark.parametrize("name", list(CASES))
def test_each_gradient_is_reduced_once_per_axis(name, gangs):
    pairs.check_reduced_once(name, CASES, gangs)


@pytest.mark.parametrize("name", FORWARD)
def test_dense_and_expert_choice_forward_over_ep(name, gangs, reference):
    pairs.check_forward(name, CASES, gangs, reference)
