"""Pipeline parallelism in the port's training (``parallel/pipeline.py``),
held against the JAX package's on its CPU mesh: the cases of the
reference's ``TestPipeline`` (``tests/test_moe_pp.py``) on a gloo gang
of 8 ranks at dp2 x pp4.

- llama_tiny at 4 layers (f32): the forward of 8 rows at 4 microbatches
  against JAX's pipelined forward on its dp2 x pp4 mesh (atol = rtol =
  2e-5, the reference test's), under both schedules, whose logits are
  equal bit for bit; the gradient of ``sum(logits ** 2) / 1e4`` at 2
  microbatches, each stage's leaves summed over the stages, against
  JAX's (rel 1e-4 per leaf);
- two adamw steps through the train step at dp2 x pp4 against JAX's
  train step there (loss and grad norm to rel 1e-5, gradients to rel
  1e-4);
- the four refusals, with the reference's messages;
- three bf16 steps of ``run_torchjob`` at dp2 x pp4, finite.

Each gloo rank splits its own rows into microbatches, where GSPMD splits
the global batch (ROADMAP.md, Queue 3), so the bf16 run draws 4 rows per
process.
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

AXES = {"dp": 2, "pp": 4}
OVERRIDES = {"n_layers": 4, "max_seq_len": 64, "pipeline_stages": 4}
STEP_OVERRIDES = {"n_layers": 4, "pipeline_stages": 4,
                  "pipeline_microbatches": 2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return {"params0": ref.drawn_params("llama_tiny", {"n_layers": 4}),
            "tokens": rng.integers(0, 256, (8, 64)).astype(np.int32),
            "grad_tokens": rng.integers(0, 256, (4, 64)).astype(np.int32),
            "host": ref.host_batches("llama_tiny", 2, 32, 2)}


@pytest.fixture(scope="module")
def gang(inputs, tmp_path_factory):
    """The 8-rank gang, started in a thread while JAX computes."""
    from concurrent.futures import ThreadPoolExecutor

    cases = [
        {"name": "pipe", "kind": "pipeline", "axes": AXES,
         "overrides": dict(OVERRIDES, pipeline_microbatches=4),
         "params0": inputs["params0"], "tokens": inputs["tokens"],
         "grad_tokens": inputs["grad_tokens"], "grad_micro": 2},
        {"name": "steps", "axes": AXES, "model": "llama_tiny",
         "overrides": STEP_OVERRIDES, "params0": inputs["params0"],
         "batches": inputs["host"]},
        {"name": "bf16", "kind": "job",
         "artifacts": str(tmp_path_factory.mktemp("bf16")),
         "job": _job(AXES, 3, seq_len=128, global_batch_size=32,
                     dtype="bfloat16", n_layers=4, pipeline_stages=4,
                     pipeline_microbatches=4)},
    ]
    pool = ThreadPoolExecutor(1)
    future = pool.submit(torch_dist.run, parallel_steps, 8, cases)
    yield future
    pool.shutdown()


def _jcfg(**kw):
    from polyaxon_tpu.models import llama as jllama

    return dataclasses.replace(jllama.CONFIGS["llama_tiny"],
                               dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def reference(inputs, gang):
    from polyaxon_tpu.models import llama as jllama

    params = jax.tree.map(jnp.asarray, inputs["params0"])
    mesh = ref.jax_mesh(AXES)
    fwd_cfg = _jcfg(**OVERRIDES, pipeline_microbatches=4)
    grad_cfg = _jcfg(**OVERRIDES, pipeline_microbatches=2)
    tokens = jnp.asarray(inputs["tokens"])
    grad_tokens = jnp.asarray(inputs["grad_tokens"])
    with mesh:
        logits = np.asarray(jax.jit(lambda p, t: jllama.forward(
            fwd_cfg, p, t))(params, tokens))
        grads = jax.jit(jax.grad(lambda p: jnp.sum(jllama.forward(
            grad_cfg, p, grad_tokens) ** 2) / 1e4))(params)
    return {"logits": logits,
            "grads": ref.flat(jax.tree.map(np.asarray, grads)),
            "steps": ref.jax_steps(
                "llama_tiny", STEP_OVERRIDES, AXES, inputs["params0"],
                ref.copies(inputs["host"], 8),
                _job(AXES, 2)["runtime"]),
            "step_grads": ref.jax_grads("llama_tiny", {"n_layers": 4},
                                        inputs["params0"],
                                        inputs["host"][0])}


@pytest.mark.parametrize("double_buffer", [False, True],
                         ids=["single", "double"])
def test_forward_matches_jax(double_buffer, gang, reference):
    ranks = gang.result()
    for r in ranks:  # every stage holds the last stage's logits
        got = r["pipe"][double_buffer]["logits"]
        np.testing.assert_allclose(got, reference["logits"], atol=2e-5,
                                   rtol=2e-5)
        # The two schedules move ticks, not values.
        np.testing.assert_array_equal(r["pipe"][False]["logits"],
                                      r["pipe"][True]["logits"])


@pytest.mark.parametrize("double_buffer", [False, True],
                         ids=["single", "double"])
def test_gradients_match_jax(double_buffer, gang, reference):
    ranks = gang.result()
    for dp in range(2):  # ranks of one pp group: dp * 4 + stage
        stages = [ranks[dp * 4 + s]["pipe"][double_buffer]["grads"]
                  for s in range(4)]
        for name, want in reference["grads"].items():
            got = sum(g[name] for g in stages)
            ref.assert_leaf_close(got, want, ref.GRAD_RTOL, name)
        # A stage's layer slice is its own: the others' are zero.
        assert not stages[1]["layers/wq"][:1].any()
        assert stages[1]["layers/wq"][1].any()


def test_train_steps_match_jax(gang, reference):
    ranks = gang.result()
    for r in ranks:
        ref.assert_matches(r["steps"], reference["steps"],
                           reference["step_grads"])
        np.testing.assert_array_equal(r["steps"]["params"]["embed"],
                                      ranks[0]["steps"]["params"]["embed"])


def test_bf16_pipeline_trains(gang):
    ranks = gang.result()
    assert [r["bf16"]["steps"] for r in ranks] == [3] * 8
    losses = ranks[0]["bf16"]["losses"]
    assert sorted(losses) == [1, 2] and np.isfinite(list(losses.values())
                                                    ).all()
    assert [r["bf16"]["units_per_step"] for r in ranks] == [4 * 2 * 128] * 8


def _mesh():
    from polyaxon_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(axes=AXES, devices=range(8))


def _tcfg(**kw):
    from polyaxon_tpu_torch.models import llama

    return dataclasses.replace(llama.CONFIGS["llama_tiny"],
                               dtype=torch.float32, max_seq_len=64,
                               n_layers=4, **kw)


def _params(cfg):
    from polyaxon_tpu_torch.models import llama

    return llama.init(cfg, torch.Generator().manual_seed(0),
                      device="cpu")["params"]


def test_batch_must_divide_microbatches():
    from polyaxon_tpu_torch.parallel.pipeline import pipeline_forward

    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(_mesh(), lambda p, x: x,
                         {"w": torch.zeros((4, 2))}, torch.zeros((6, 8)),
                         n_microbatches=4)


def test_layers_must_divide_stages():
    from polyaxon_tpu_torch.parallel.pipeline import stack_stages

    with pytest.raises(ValueError, match="divide"):
        stack_stages({"w": torch.zeros((6, 2))}, 4)


def test_stage_count_must_match_mesh():
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.parallel.mesh import use_mesh

    cfg = _tcfg(pipeline_stages=2, pipeline_microbatches=2)
    with use_mesh(_mesh()):  # mesh pp=4 != 2 declared stages
        with pytest.raises(ValueError, match="must match"):
            llama.forward(cfg, _params(cfg), torch.zeros((4, 64),
                                                         dtype=torch.long))


def test_explicit_positions_rejected():
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.parallel.mesh import use_mesh

    cfg = _tcfg(pipeline_stages=4, pipeline_microbatches=2)
    with use_mesh(_mesh()):
        with pytest.raises(ValueError, match="contiguous positions"):
            llama.forward(cfg, _params(cfg),
                          torch.zeros((4, 64), dtype=torch.long),
                          torch.zeros((4, 64), dtype=torch.int32))


@pytest.mark.parametrize("double_buffer", [False, True],
                         ids=["single", "double"])
def test_replay_runs_each_microbatch_through_every_stage(double_buffer):
    """``replay_pipeline`` (the schedule ``pipeline_forward`` runs, every
    stage in one process) equals each microbatch taken through the
    stages in order, bit for bit, and so do the gradients."""
    from polyaxon_tpu_torch.parallel.pipeline import replay_pipeline

    gen = torch.Generator().manual_seed(4)
    w = torch.randn((4, 16, 16), generator=gen).requires_grad_()
    x = torch.randn((6, 5, 16), generator=gen)

    def stage(p, h):
        return torch.tanh(h @ p["w"])

    got = replay_pipeline(stage, {"w": w}, x, n_microbatches=3,
                          n_stages=4, double_buffer=double_buffer)
    (g_got,) = torch.autograd.grad(got.square().sum(), w)
    want = []
    for mb in x.reshape(3, 2, 5, 16).unbind(0):
        for s in range(4):
            mb = stage({"w": w[s]}, mb)
        want.append(mb)
    want = torch.cat(want)
    (g_want,) = torch.autograd.grad(want.square().sum(), w)
    assert torch.equal(got, want)
    torch.testing.assert_close(g_got, g_want, rtol=1e-6, atol=1e-6)


def test_lora_over_a_pipelined_model_is_refused():
    """No longer refused: the reference trains LoRA over a pipelined
    llama (its adapters merged into the weights before the stages split
    them), and so does the port, whose adapted weights split into stages
    as plain tensors do (held against the reference's steps in
    ``tests/test_torch_sharded_repairs.py``)."""
    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.models.lora import lora_model_def

    wrapped = lora_model_def(get_model("llama_tiny", **STEP_OVERRIDES), 4,
                             8.0)
    assert wrapped.pipeline_parallel and not wrapped.sharded_init
