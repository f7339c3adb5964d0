"""Tensor and sequence parallelism in the port's training, held against
the JAX package's train step in gloo gangs on the CPU.

Each family (``llama_tiny``; ``gemma_tiny``, MQA, whose one KV head every
tp rank computes whole; ``moe_tiny`` at no-drop capacity; ``t5_tiny``,
which gathers its tp shards and computes replicated) takes two adamw
steps (f32, clipping on) from the same weights on the same rows at tp2,
tp4, dp2 x tp2 and dp2 x fsdp2 x tp2, and llama_tiny and t5_tiny at
dp2 x sp2, and LoRA adapters over llama_tiny at tp2, tp4 and dp2 x tp2
(only the adapters train; their gradients are compared). GSPMD
computes the same function on every mesh, so the
reference is JAX's train step on its dp2 x fsdp2 x tp2 mesh (the mesh of
its own ``test_runs_sharded_jaxjob``; dp2 x sp2 for the sp cases) and
the gradient of JAX's ``apply`` on one device: every rank's losses to
rel 1e-5 (the second step's too), the first grad norm to rel 1e-5, and
the first step's reduced gradient of every leaf, tp-sharded and
replicated alike, to rel 1e-4 as a whole (``tests/torch_jax_ref.py``).
Every process draws the same rows (ROADMAP.md, Queue 3), and a mean
over copies of the same rows is the mean over the rows, so one set of
reference numbers holds for every mesh.

The vocab-parallel cross entropy alone (tp2, ties across the shards'
maxima included) against ``cross_entropy_loss`` and its gradient. A
checkpoint saved by a dp1 x tp2 gang restores at fsdp2 and on one
device, each resumed run's losses those of an uninterrupted one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_dist
from tests import torch_jax_ref as ref
from tests.torch_dist_cases import _job, parallel_steps

PER_HOST, SEQ, STEPS = 2, 32, 2
FAMILIES = {
    "llama_tiny": {},
    "gemma_tiny": {},
    "moe_tiny": {"capacity_factor": 8.0},
    "t5_tiny": {},
}
TP_MESHES = {"tp2": {"tp": 2}, "tp4": {"tp": 4},
             "dp2xtp2": {"dp": 2, "tp": 2},
             "dp2xfsdp2xtp2": {"dp": 2, "fsdp": 2, "tp": 2}}
SP_MESHES = {"dp2xsp2": {"dp": 2, "sp": 2}}
SP_FAMILIES = ("llama_tiny", "t5_tiny")
JAX_TP_MESH = {"dp": 2, "fsdp": 2, "tp": 2}
# LoRA over llama_tiny: the projections, the embedding and the head, so
# that each adapter factor that is whole on every tp rank meets a tp
# shard (A of the column-parallel wq/wk/wv/w_gate/w_up and the head, B
# of the row-parallel wo/w_down and the vocab-parallel embedding); at
# tp4 wk and wv are gathered whole (2 KV heads over 4 ranks).
LORA = "llama_tiny+lora"
LORA_SPEC = {"rank": 4, "alpha": 8.0,
             "targets": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                         "embed", "lm_head")}
LORA_MESHES = ("tp2", "tp4", "dp2xtp2")

CASES = ([(f, m) for m in TP_MESHES for f in FAMILIES]
         + [(f, m) for m in SP_MESHES for f in SP_FAMILIES]
         + [(LORA, m) for m in LORA_MESHES])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _extra(model):
    return {"dataset": "seq2seq_synthetic"} if model == "t5_tiny" else {}


def _runtime(model):
    return _job({}, STEPS, model=model, **_extra(model))["runtime"]


def _adapters(base: dict) -> dict:
    """LORA_SPEC's adapters of ``base`` as numpy, B drawn nonzero (as
    ``init_lora`` starts it, at zero, A's gradient would be zero)."""
    import jax.numpy as jnp

    from polyaxon_tpu.models import lora as jlora

    shapes = jax.eval_shape(lambda b, k: jlora.init_lora(
        b, LORA_SPEC["rank"], LORA_SPEC["targets"], k),
        jax.tree.map(jnp.asarray, base), jax.random.key(1))
    rng = np.random.default_rng(5)
    return {k: {"a": rng.standard_normal(v["a"].shape).astype(np.float32)
                * LORA_SPEC["rank"] ** -0.5,
                "b": 0.1 * rng.standard_normal(v["b"].shape).astype(
                    np.float32)}
            for k, v in sorted(shapes.items())}


@pytest.fixture(scope="module")
def inputs():
    out = {f: (ref.drawn_params(f, ov),
               ref.host_batches(f, PER_HOST, SEQ, STEPS))
           for f, ov in FAMILIES.items()}
    base, host = out["llama_tiny"]
    out[LORA] = (base, host, dict(LORA_SPEC, adapters=_adapters(base)))
    return out


@pytest.fixture(scope="module")
def reference(inputs, gangs):
    """Per family and kind of mesh: JAX's steps; per family: JAX's
    gradient on one device."""
    out = {}
    for f, ov in FAMILIES.items():
        params0, host = inputs[f]
        meshes = {"tp": JAX_TP_MESH}
        if f in SP_FAMILIES:
            meshes["sp"] = SP_MESHES["dp2xsp2"]
        for kind, axes in meshes.items():
            world = int(np.prod(list(axes.values())))
            out[f, kind] = ref.jax_steps(
                f, ov, axes, params0, ref.copies(host, world), _runtime(f))
        out[f, "grads"] = ref.jax_grads(f, ov, params0, host[0])
    base, host, lora = inputs[LORA]
    params0 = ref.lora_params(base, lora)
    out[LORA, "tp"] = ref.jax_steps(
        "llama_tiny", {}, JAX_TP_MESH, params0, ref.copies(host, 8),
        _runtime("llama_tiny"), lora=lora)
    grads = ref.jax_grads("llama_tiny", {}, params0, host[0], lora=lora)
    out[LORA, "grads"] = {k: v for k, v in grads.items()
                          if k.startswith("lora/") and "/_meta/" not in k}
    return out


def _ce_case():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((24, 64)).astype(np.float32)
    # Ties across the two shards' maxima: argmax takes the lower index.
    logits[0, 5] = logits[0, 40] = 9.0
    logits[1, 33] = logits[1, 60] = 9.0
    labels = rng.integers(0, 64, 24).astype(np.int64)
    labels[0], labels[1] = 5, 33
    mask = (rng.random(24) > 0.2).astype(np.float32)
    return {"name": "ce", "kind": "vocab_ce", "logits": logits,
            "labels": labels, "mask": mask}


def _ckpt_job(axes, steps, gbs):
    return dict(_job(axes, steps, global_batch_size=gbs),
                checkpointing={"enabled": True, "intervalSteps": 100})


@pytest.fixture(scope="module")
def gangs(inputs, tmp_path_factory):
    """One gang per world size, all started at once in threads (the JAX
    reference computes meanwhile): the cases of that size; the 2-rank
    gang also runs the vocab-parallel CE and the checkpoint's dp1 x tp2
    and fsdp2 runs."""
    from concurrent.futures import ThreadPoolExecutor

    artifacts = str(tmp_path_factory.mktemp("ckpt") / "run")
    by_world: dict = {2: [_ce_case(),
                          {"name": "a", "kind": "job", "artifacts": artifacts,
                           "job": _ckpt_job({"dp": 1, "tp": 2}, 3, 4)},
                          {"name": "b", "kind": "job", "artifacts": artifacts,
                           "job": _ckpt_job({"fsdp": 2}, 5, 4)}]}
    for f, m in CASES:
        axes = {**TP_MESHES, **SP_MESHES}[m]
        params0, host, *lora = inputs[f]
        model = f.split("+")[0]
        case = {"name": f"{f}/{m}", "axes": axes, "model": model,
                "overrides": FAMILIES[model], "params0": params0,
                "batches": host, "runtime": _extra(model)}
        if lora:
            case["lora"] = lora[0]
        by_world.setdefault(int(np.prod(list(axes.values()))), []).insert(
            0, case)
    pool = ThreadPoolExecutor(len(by_world))
    futures = {w: pool.submit(torch_dist.run, parallel_steps, w, cases)
               for w, cases in by_world.items()}
    yield {"futures": futures, "artifacts": artifacts}
    pool.shutdown()


@pytest.mark.parametrize("family,mesh", CASES,
                         ids=[f"{f}-{m}" for f, m in CASES])
def test_steps_match_jax(family, mesh, gangs, reference):
    axes = {**TP_MESHES, **SP_MESHES}[mesh]
    ranks = gangs["futures"][int(np.prod(list(axes.values())))].result()
    kind = "sp" if mesh in SP_MESHES else "tp"
    want = reference[family, kind]
    got = ranks[0][f"{family}/{mesh}"]
    ref.assert_matches(got, want, reference[family, "grads"])
    # Every rank reports the same metrics and holds the same model.
    for r in ranks[1:]:
        other = r[f"{family}/{mesh}"]
        assert other["loss"] == got["loss"]
        assert other["grad_norm"] == got["grad_norm"]
        for name, p in got["params"].items():
            np.testing.assert_array_equal(other["params"][name], p,
                                          err_msg=name)


def test_vocab_parallel_ce_matches_cross_entropy(gangs):
    from polyaxon_tpu.models.common import cross_entropy_loss

    case = _ce_case()
    ranks = gangs["futures"][2].result()
    labels, mask = jnp.asarray(case["labels"]), jnp.asarray(case["mask"])

    def loss(z):
        return cross_entropy_loss(z, labels, mask)

    want_loss, want_acc = loss(jnp.asarray(case["logits"]))
    want_grad = np.asarray(jax.grad(lambda z: loss(z)[0])(
        jnp.asarray(case["logits"])))
    for r in ranks:
        np.testing.assert_allclose(r["ce"]["loss"], float(want_loss),
                                   rtol=ref.LOSS_RTOL)
        assert r["ce"]["accuracy"] == pytest.approx(float(want_acc),
                                                    abs=1e-7)
    got_grad = np.concatenate([r["ce"]["grad"] for r in ranks], axis=1)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [2, 4])
def test_replay_vocab_ce_matches_cross_entropy(n):
    """``replay_vocab_ce`` (the vocab-parallel Function with every shard
    in one process) against ``cross_entropy_loss``: loss, accuracy and
    the gradient of its custom backward."""
    from polyaxon_tpu.models.common import cross_entropy_loss
    from polyaxon_tpu_torch.parallel.tensor import replay_vocab_ce

    case = _ce_case()
    labels, mask = jnp.asarray(case["labels"]), jnp.asarray(case["mask"])

    def loss(z):
        return cross_entropy_loss(z, labels, mask)

    want_loss, want_acc = loss(jnp.asarray(case["logits"]))
    want_grad = np.asarray(jax.grad(lambda z: loss(z)[0])(
        jnp.asarray(case["logits"])))
    logits = torch.from_numpy(case["logits"]).requires_grad_()
    tmask = torch.from_numpy(case["mask"])
    nll, hit = replay_vocab_ce(list(logits.chunk(n, -1)),
                               torch.from_numpy(case["labels"]))
    got_loss = (nll * tmask).sum() / tmask.sum()
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=ref.LOSS_RTOL)
    assert float((hit * tmask).sum() / tmask.sum()) == pytest.approx(
        float(want_acc), abs=1e-7)
    np.testing.assert_allclose(logits.grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-7)


def test_checkpoint_moves_from_tp_to_fsdp_and_one_device(gangs):
    """Saved at dp1 x tp2 (step 3), restored at fsdp2 (to step 5), then
    on one device (to step 7): each run's emitted losses are an
    uninterrupted one-device run's at the same steps (a restored run's
    first step is its warm-up, not emitted). Every run draws the same
    2-row stream per process."""
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    def record(into):
        return lambda s, v: into.__setitem__(s, v["loss"]) \
            if "loss" in v else None

    ranks = gangs["futures"][2].result()
    losses: dict = {}
    third = run_torchjob(_ckpt_job({"dp": 1}, 7, 2),
                         artifacts_dir=gangs["artifacts"], device="cpu",
                         on_metrics=record(losses))
    assert [r["a"]["steps"] for r in ranks] == [3, 3]
    assert [r["b"]["restored_from_step"] for r in ranks] == [3, 3]
    assert third.restored_from_step == 5 and third.steps == 7

    plain: dict = {}
    run_torchjob(_job({"dp": 1}, 7, global_batch_size=2), device="cpu",
                 on_metrics=record(plain))
    got = {**ranks[0]["a"]["losses"], **ranks[0]["b"]["losses"], **losses}
    assert sorted(got) == [1, 2, 4, 6]
    for step, loss in got.items():
        np.testing.assert_allclose(loss, plain[step], rtol=ref.LOSS_RTOL,
                                   err_msg=str(step))
