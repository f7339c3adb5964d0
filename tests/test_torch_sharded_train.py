"""The port's train step over a mesh of gloo processes, held against the
JAX package's train step on the CPU mesh of the same shape.

Three adamw steps of llama_tiny (f32, clipping on) from JAX's initial
weights: dp2 x fsdp2 on 4 ranks (parameters sharded on ``embed``,
gathered per layer at use), and with ring attention dp1 x cp4, dp2 x cp2
and fsdp2 x cp2 on 4 ranks (the loss weighted over dp x cp; the fsdp
gathers and the ring's transfers in one backward). Every rank trains on
the same rows, as the reference's processes do (each draws its
per-process rows from one seed: ROADMAP.md, Queue 3), so the JAX step
gets the global batch those processes would assemble: the rows once per
batch shard (4 copies at dp2 x fsdp2, 2 under cp2, once at dp1 x cp4,
where the batch is replicated). A dp1 x cp4 loop counts the tokens a
step trains. Losses and grad norms
agree to the trajectory test's tolerances (abs 1e-4 and rel 1e-4),
parameters to 2e-5 after three steps; the port's one-device step on
that global batch agrees to 1e-5.

A checkpoint saved by a dp2 x fsdp2 gang (``run_torchjob`` in every
rank) and restored by a dp4 gang resumes bitwise: the parameters and
moments at the end equal those of the same steps run without the
checkpoint, the state moved between the meshes in memory.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.parallel import rules_for_mesh as jrules
from polyaxon_tpu.runtime import data as jdata
from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
from polyaxon_tpu.runtime.optim import build_optimizer as jbuild
from polyaxon_tpu.runtime.step import build_init as jinit
from polyaxon_tpu.runtime.step import build_train_step as jstep
from polyaxon_tpu_torch.models import get_model
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.runtime import optim as toptim
from polyaxon_tpu_torch.runtime.checkpoint import load_tree
from polyaxon_tpu_torch.runtime.config import RuntimeConfig
from polyaxon_tpu_torch.runtime.step import build_init, build_train_step
from tests import torch_dist
from tests.torch_dist_cases import _job, replaced_run, run_job, train_steps

STEPS = 3
PER_HOST = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _host_batches():
    """The rows each process draws (every process the same)."""
    it = jdata.lm_synthetic(batch_size=PER_HOST, seq_len=64,
                            vocab_size=256, seed=0)
    return [next(it) for _ in range(STEPS)]


def _jax_trajectory(axes, cpu_devices, batches, impl):
    names = tuple(axes)
    world = int(np.prod([axes[a] for a in names]))
    mesh = Mesh(np.array(cpu_devices[:world]).reshape(
        [axes[a] for a in names]), names)
    spec = _job(axes, STEPS)["runtime"]
    model = jllama.model_def("llama_tiny", dtype=jnp.float32, loss_chunk=16,
                             attention_impl=impl)
    opt = jbuild(JCfg(**spec))
    with mesh:
        rules = jrules(mesh)
        state = jinit(model, opt, mesh, rules)(jax.random.key(0))
        params0 = jax.tree.map(np.asarray, state["params"])
        train = jstep(model, opt, mesh, rules)
        losses, norms = [], []
        for b in batches:
            state, m = train(state, jax.tree.map(jnp.asarray, b),
                             jax.random.key(1))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        params = jax.tree.map(np.asarray, state["params"])
    return params0, losses, norms, params


def _one_device(params0, batches):
    spec = _job({"dp": 1}, STEPS)["runtime"]
    model_def = get_model("llama_tiny", dtype=torch.float32, loss_chunk=16)
    opt = toptim.build_optimizer(RuntimeConfig.from_dict(spec))
    params = tllama.params_from_numpy(model_def.config, params0,
                                      device="cpu")
    state = build_init(model_def, opt, device="cpu", params=params)(0)
    step = build_train_step(model_def, opt)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("axes,impl,copies", [
    ({"dp": 2, "fsdp": 2}, "xla", 4),
    ({"dp": 1, "cp": 4}, "ring", 1),
    ({"dp": 2, "cp": 2}, "ring", 2),
    ({"fsdp": 2, "cp": 2}, "ring", 2),
], ids=["dp2xfsdp2", "dp1xcp4_ring", "dp2xcp2_ring", "fsdp2xcp2_ring"])
def test_sharded_steps_match_jax(axes, impl, copies, cpu_devices):
    host = _host_batches()
    # The global batch the reference's processes assemble.
    global_batches = [{k: np.concatenate([v] * copies) for k, v in b.items()}
                      for b in host]
    params0, losses, norms, params = _jax_trajectory(
        axes, cpu_devices, global_batches, impl)
    ranks = torch_dist.run(train_steps, 4, axes, params0, host, impl)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], losses, rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["grad_norm"], norms, rtol=1e-4)
    want = _flat(params)
    for key, got in _flat(ranks[0]["params"]).items():
        np.testing.assert_allclose(got, want[key], atol=2e-5, rtol=1e-4,
                                   err_msg=key)
    # Every rank holds the same model.
    for r in ranks[1:]:
        for key, got in _flat(r["params"]).items():
            np.testing.assert_array_equal(got, _flat(ranks[0]["params"])[key])
    np.testing.assert_allclose(_one_device(params0, global_batches),
                               ranks[0]["loss"], rtol=0, atol=1e-5)


def test_cp_step_counts_the_tokens_it_trains(tmp_path):
    """At dp1 x cp4 the four ranks cut one set of rows into sequence
    shards: a step trains global_batch / 4 rows, and throughput and MFU
    count those tokens."""
    ranks = torch_dist.run(run_job, 4, _job({"dp": 1, "cp": 4}, 2,
                                            global_batch_size=8,
                                            attention_impl="ring"),
                           str(tmp_path / "run"))
    assert [r["units_per_step"] for r in ranks] == [8 // 4 * 64] * 4
    assert [r["steps"] for r in ranks] == [2] * 4


def test_checkpoint_moves_meshes_bitwise(tmp_path):
    artifacts = str(tmp_path / "run")
    ckpt = {"enabled": True, "intervalSteps": 100}
    first = torch_dist.run(
        run_job, 4, dict(_job({"dp": 2, "fsdp": 2}, 2), checkpointing=ckpt),
        artifacts)
    assert first[0]["steps"] == 2 and sorted(first[0]["losses"]) == [1]
    resumed = torch_dist.run(
        run_job, 4, dict(_job({"dp": 4}, 4), checkpointing=ckpt), artifacts)
    assert all(r["restored_from_step"] == 2 for r in resumed)
    assert sorted(resumed[0]["losses"]) == [3]
    assert not resumed[1]["losses"]  # rank 0 alone emits

    reference = torch_dist.run(replaced_run, 4, {"dp": 2, "fsdp": 2},
                               {"dp": 4}, 2, 4)[0]
    step, saved = load_tree(f"{artifacts}/checkpoints")
    assert step == 4
    got = _flat({"params": saved["params"], "opt_state": saved["opt_state"]})
    want = _flat({"params": reference["params"],
                  "opt_state": {k: (dict(enumerate(v)) if isinstance(v, list)
                                    else v)
                                for k, v in reference["opt_state"].items()}})
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=key)
