"""Expert parallelism in the port's MoE (``models/moe.py``), held against
the JAX package's sharded ragged dispatch on its CPU mesh: the cases of
the reference's ``test_ragged_matches_dense_under_ep_mesh``,
``test_ragged_gradients_match_dense_under_ep_mesh`` and
``test_trains_on_ep_mesh`` (``tests/test_moe_pp.py``) on gloo gangs.

Every rank holds its own rows (the batch is sharded over dp and ep, in
rank order) and ``moe_tiny``'s four experts split over ep:

- dp1 x ep4 at the default capacity (1.25): the forward (logits to atol
  = rtol = 1e-5, the router aux to rel 1e-5), and two adamw steps
  through the train step (losses and the first grad norm to rel 1e-5,
  every leaf's gradient to rel 1e-4) against JAX's forward, gradient
  and train step on its dp1 x ep4 mesh;
- dp2 x ep2 at no-drop capacity (8.0), the same checks;
- dp1 x ep4 and dp2 x ep2 at a capacity that binds (0.5), the forward,
  and at dp2 x ep2 the steps too: the same drops as JAX (at these
  sizes 1.25 drops nothing). JAX's dispatch at dp2 x ep2 spans both dp
  halves of the batch (its ``shard_map`` over ep leaves dp
  automatic); the port's does too, from the counts of every batch
  block, and so differs from JAX's dp1 x ep2 function of each half;
- three steps of ``run_torchjob`` at dp2 x ep4 (8 ranks), finite, with
  a router aux above zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_dist
from tests import torch_jax_ref as ref
from tests.torch_dist_cases import _job, parallel_steps

NO_DROP = {"capacity_factor": 8.0}
# Capacity that binds at these sizes: pairs are dropped at the send
# buffers and at the owners.
TIGHT = {"capacity_factor": 0.5}
CASES = {"dp1xep4": ({"dp": 1, "ep": 4}, {}),
         "dp2xep2_nodrop": ({"dp": 2, "ep": 2}, NO_DROP),
         "dp2xep2_tight": ({"dp": 2, "ep": 2}, TIGHT)}
FORWARD_CASES = {**CASES, "dp1xep4_tight": ({"dp": 1, "ep": 4}, TIGHT)}
ROWS, SEQ = 2, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    return {"params0": ref.drawn_params("moe_tiny", {}),
            "tokens": rng.integers(0, 256, (4 * ROWS, SEQ)).astype(np.int32),
            # Two steps' rows for each of the 4 ranks.
            "rank_batches": [[{"tokens": rng.integers(
                0, 256, (ROWS, SEQ)).astype(np.int32)} for _ in range(2)]
                for _ in range(4)]}


@pytest.fixture(scope="module")
def gangs(inputs, tmp_path_factory):
    """The 4-rank and 8-rank gangs, started in threads while JAX
    computes."""
    from concurrent.futures import ThreadPoolExecutor

    cases = []
    for name, (axes, ov) in FORWARD_CASES.items():
        cases.append(
            {"name": f"{name}/fwd", "kind": "moe_forward", "axes": axes,
             "overrides": ov, "params0": inputs["params0"],
             "tokens": inputs["tokens"]})
    for name, (axes, ov) in CASES.items():
        cases.append(
            {"name": f"{name}/steps", "axes": axes, "model": "moe_tiny",
             "overrides": ov, "params0": inputs["params0"],
             "rank_batches": inputs["rank_batches"]})
    trains = [{"name": "trains", "kind": "job",
               "artifacts": str(tmp_path_factory.mktemp("ep")),
               "job": _job({"dp": 2, "ep": 4}, 3, model="moe_tiny",
                           seq_len=128, global_batch_size=8)}]
    pool = ThreadPoolExecutor(2)
    futures = {4: pool.submit(torch_dist.run, parallel_steps, 4, cases),
               8: pool.submit(torch_dist.run, parallel_steps, 8, trains)}
    yield futures
    pool.shutdown()


def _jax_forward(axes, overrides, params0, tokens):
    from polyaxon_tpu.models import moe as jmoe
    from polyaxon_tpu.parallel import rules_for_mesh as jrules
    from polyaxon_tpu.parallel.sharding import tree_shardings

    cfg = dataclasses.replace(jmoe.CONFIGS["moe_tiny"], dtype=jnp.float32,
                              dispatch="ragged", **overrides)
    mesh = ref.jax_mesh(axes)
    with mesh:
        params = jax.device_put(params0, tree_shardings(
            jmoe.logical_axes(cfg)["params"], mesh, jrules(mesh)))
        logits, aux = jax.jit(lambda p, t: jmoe.forward(cfg, p, t))(
            params, jnp.asarray(tokens))
    return np.asarray(logits), float(aux)


@pytest.fixture(scope="module")
def reference(inputs, gangs):
    out = {}
    params0, tokens = inputs["params0"], inputs["tokens"]
    batches = [{"tokens": np.concatenate([rb[i]["tokens"]
                                          for rb in inputs["rank_batches"]])}
               for i in range(2)]
    for name, (axes, ov) in FORWARD_CASES.items():
        out[name, "fwd"] = _jax_forward(axes, ov, params0, tokens)
    for name, (axes, ov) in CASES.items():
        out[name, "steps"] = ref.jax_steps(
            "moe_tiny", ov, axes, params0, batches,
            _job(axes, 2, model="moe_tiny")["runtime"])
        out[name, "grads"] = ref.jax_grads("moe_tiny", ov, params0,
                                           batches[0], axes=axes)
    half = len(tokens) // 2
    out["per_half"] = [_jax_forward({"dp": 1, "ep": 2}, TIGHT, params0,
                                    tokens[i * half:(i + 1) * half])
                       for i in range(2)]
    return out


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case, gangs, reference):
    ranks = gangs[4].result()
    logits = np.concatenate([r[f"{case}/fwd"]["logits"] for r in ranks])
    want_logits, want_aux = reference[case, "fwd"]
    np.testing.assert_allclose(logits, want_logits, atol=1e-5, rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/fwd"]["aux"], want_aux,
                                   rtol=ref.LOSS_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case, gangs, reference):
    ranks = gangs[4].result()
    for r in ranks:
        ref.assert_matches(r[f"{case}/steps"], reference[case, "steps"],
                           reference[case, "grads"])


def test_tight_capacity_drops_as_jax(gangs, reference):
    """At a capacity that binds, dp1 x ep4 drops what JAX drops (held in
    ``test_forward_matches_jax``), and the drops change the output."""
    ranks = gangs[4].result()
    tight = np.concatenate([r["dp1xep4_tight/fwd"]["logits"] for r in ranks])
    loose = np.concatenate([r["dp1xep4/fwd"]["logits"] for r in ranks])
    assert np.abs(tight - loose).max() > 1e-3


def test_binding_capacity_dispatches_per_dp_shard(gangs, reference):
    """At dp2 x ep2 and a capacity that binds, the dispatch groups are
    not the dp shards: the port's forward is JAX's dp2 x ep2 one (held
    in ``test_forward_matches_jax``), whose capacities and slots span
    both dp halves, and not JAX's dp1 x ep2 forward of each half."""
    ranks = gangs[4].result()
    got = np.concatenate([r["dp2xep2_tight/fwd"]["logits"] for r in ranks])
    np.testing.assert_allclose(got, reference["dp2xep2_tight", "fwd"][0],
                               atol=1e-5, rtol=1e-5)
    per_half = np.concatenate([logits for logits, _ in
                               reference["per_half"]])
    assert np.abs(got - per_half).max() > 1e-3


def test_trains_on_ep_mesh(gangs):
    ranks = gangs[8].result()
    assert [r["trains"]["steps"] for r in ranks] == [3] * 8
    final = ranks[0]["trains"]["final_metrics"]
    assert np.isfinite(final["loss"])
    assert final["router_aux"] > 0
    # The 8 ranks hold 8 batch shards of one row each.
    assert ranks[0]["trains"]["units_per_step"] == 8 * 128
