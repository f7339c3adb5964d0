"""Training over a mesh of gloo processes, held against the JAX package's
train step on its CPU mesh: the repairs of MoE's microbatches and dense
dispatch, each rank drawing only its shards, adafactor over sharded
leaves, batch statistics across ranks and LoRA under pp.

- Microbatches of the global batch: moe_tiny at dp2 x accum 2 with a
  capacity that binds (0.5, the ragged dispatch), each rank's rows laid
  out as the loop lays them (``runtime/step.py rank_rows``): losses,
  router aux and grad norm to rel 1e-5, every leaf's gradient to rel
  1e-4 (``tests/test_torch_expert_parallel.py``'s tolerances) against
  JAX's accumulated step; the rows cut as they stand compute another
  function.
- The dense dispatch's counts over the global batch: moe_tiny's forward
  at dp2 and fsdp2 with ``dispatch: dense`` and a binding capacity,
  logits to atol = rtol = 1e-5 and the router aux to rel 1e-5.
- Each rank draws only its shards: llama_tiny (4 layers) at tp4 and
  fsdp4 from seed 0 holds the bytes of its shards, makes no tensor
  larger than the largest slab the draw needs (a layer of a stacked
  leaf, or a whole leaf), and its pieces gathered equal a one-rank init
  from the seed bit for bit.
- Adafactor over sharded leaves: llama_tiny, three steps at fsdp2, tp2
  and fsdp4.
- Batch statistics across ranks: resnet_tiny at dp2, and at dp2 x accum
  2, two steps (the running statistics to atol = rtol = 1e-5, equal on
  every rank).
- LoRA under pp: llama_tiny (4 layers, 2 stages of 2 microbatches) at
  dp1 x pp2, two steps, the adapters' gradients.
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

TIGHT = {"capacity_factor": 0.5}
DENSE = {"dispatch": "dense", "capacity_factor": 0.5}
PP = {"n_layers": 4, "pipeline_stages": 2, "pipeline_microbatches": 2}
LORA = {"rank": 4, "alpha": 8.0, "targets": ("wq", "wv", "w_down")}
ADAFACTOR = {"optimizer": "adafactor"}
ADAFACTOR_MESHES = {"fsdp2": {"fsdp": 2}, "tp2": {"tp": 2},
                    "fsdp4": {"fsdp": 4}}
INIT_MESHES = {"tp4": {"tp": 4}, "fsdp4": {"fsdp": 4}}
ROWS, SEQ = 4, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _adapters(base: dict) -> dict:
    from polyaxon_tpu.models import lora as jlora

    shapes = jax.eval_shape(lambda b, k: jlora.init_lora(
        b, LORA["rank"], LORA["targets"], k),
        jax.tree.map(jnp.asarray, base), jax.random.key(1))
    rng = np.random.default_rng(5)
    return {k: {"a": rng.standard_normal(v["a"].shape).astype(np.float32)
                * LORA["rank"] ** -0.5,
                "b": 0.1 * rng.standard_normal(v["b"].shape).astype(
                    np.float32)}
            for k, v in sorted(shapes.items())}


def _images(rng, steps: int, rows: int) -> list:
    return [{"image": rng.standard_normal((rows, 33, 33, 3)).astype(
                np.float32),
             "label": rng.integers(0, 10, (rows,)).astype(np.int32)}
            for _ in range(steps)]


@pytest.fixture(scope="module")
def inputs():
    from polyaxon_tpu_torch.models import resnet as tresnet

    rng = np.random.default_rng(11)
    variables = tresnet.init(tresnet.CONFIGS["resnet_tiny"],
                             torch.Generator().manual_seed(0), device="cpu")
    lora_base = ref.drawn_params("llama_tiny", {"n_layers": 4})
    return {
        "moe": ref.drawn_params("moe_tiny", {}),
        "llama": ref.drawn_params("llama_tiny", {}),
        "lora_base": lora_base,
        "lora": dict(LORA, adapters=_adapters(lora_base)),
        "resnet": jax.tree.map(lambda t: t.numpy(), variables),
        # Rows every process draws alike (the reference's processes'
        # duplicated rows: ROADMAP.md, Queue 3).
        "moe_rows": [{"tokens": rng.integers(0, 256, (ROWS, SEQ)).astype(
            np.int32)} for _ in range(2)],
        "llama_rows": ref.host_batches("llama_tiny", 2, 32, 3),
        "images": _images(rng, 2, ROWS),
        "tokens": rng.integers(0, 256, (4, SEQ)).astype(np.int32),
    }


def _steps_case(name, axes, model, params0, batches, overrides=None,
                **extra):
    return {"name": name, "axes": axes, "model": model,
            "overrides": overrides or {}, "params0": params0,
            "batches": batches, **extra}


@pytest.fixture(scope="module")
def gangs(inputs):
    """A 2-rank and a 4-rank gang, started in threads while JAX
    computes."""
    from concurrent.futures import ThreadPoolExecutor

    two = [
        _steps_case("moe_accum", {"dp": 2}, "moe_tiny", inputs["moe"],
                    inputs["moe_rows"], TIGHT, accum=2, loop_rows=True),
        _steps_case("moe_accum_as_cut", {"dp": 2}, "moe_tiny",
                    inputs["moe"], inputs["moe_rows"], TIGHT, accum=2),
        _steps_case("resnet_dp2", {"dp": 2}, "resnet_tiny",
                    inputs["resnet"]["params"], inputs["images"],
                    state0=inputs["resnet"]["state"]),
        _steps_case("resnet_dp2_accum2", {"dp": 2}, "resnet_tiny",
                    inputs["resnet"]["params"], inputs["images"],
                    state0=inputs["resnet"]["state"], accum=2,
                    loop_rows=True),
        _steps_case("lora_pp2", {"dp": 1, "pp": 2}, "llama_tiny",
                    inputs["lora_base"], inputs["llama_rows"][:2], PP,
                    lora=inputs["lora"]),
    ]
    for name in ("dp2", "fsdp2"):
        two.append({"name": f"dense_{name}", "kind": "moe_forward",
                    "axes": {name[:-1]: 2}, "overrides": DENSE,
                    "params0": inputs["moe"], "tokens": inputs["tokens"]})
    four = []
    for name, axes in ADAFACTOR_MESHES.items():
        case = _steps_case(f"adafactor_{name}", axes, "llama_tiny",
                           inputs["llama"], inputs["llama_rows"],
                           runtime=ADAFACTOR)
        (two if np.prod(list(axes.values())) == 2 else four).append(case)
    for name, axes in INIT_MESHES.items():
        four.append({"name": f"init_{name}", "kind": "init", "axes": axes,
                     "model": "llama_tiny", "overrides": {"n_layers": 4}})
    pool = ThreadPoolExecutor(2)
    futures = {2: pool.submit(torch_dist.run, parallel_steps, 2, two),
               4: pool.submit(torch_dist.run, parallel_steps, 4, four)}
    yield futures
    pool.shutdown()


def _micro_grads(model, overrides, params0, batch, axes, accum):
    """The gradient of JAX's accumulated step: the mean of its
    microbatches' gradients (equal rows and no mask), each computed over
    the mesh as the step computes it."""
    n = len(next(iter(batch.values()))) // accum
    parts = [ref.jax_grads(model, overrides, params0,
                           {k: v[m * n:(m + 1) * n] for k, v in batch.items()},
                           axes=axes) for m in range(accum)]
    return {k: sum(p[k] for p in parts) / accum for k in parts[0]}


def _jax_forward(axes, overrides, params0, tokens):
    from polyaxon_tpu.models import moe as jmoe
    from polyaxon_tpu.parallel import rules_for_mesh as jrules
    from polyaxon_tpu.parallel.sharding import tree_shardings

    cfg = dataclasses.replace(jmoe.CONFIGS["moe_tiny"], dtype=jnp.float32,
                              **overrides)
    mesh = ref.jax_mesh(axes)
    with mesh:
        params = jax.device_put(params0, tree_shardings(
            jmoe.logical_axes(cfg)["params"], mesh, jrules(mesh)))
        logits, aux = jax.jit(lambda p, t: jmoe.forward(cfg, p, t))(
            params, jnp.asarray(tokens))
    return np.asarray(logits), float(aux)


def _runtime(model, **extra):
    return _job({}, 3, model=model, **extra)["runtime"]


@pytest.fixture(scope="module")
def reference(inputs, gangs):
    out = {}
    moe_global = ref.copies(inputs["moe_rows"], 2)
    out["moe_accum"] = ref.jax_steps("moe_tiny", TIGHT, {"dp": 2},
                                     inputs["moe"], moe_global,
                                     _runtime("moe_tiny"), accum=2)
    out["moe_accum", "grads"] = _micro_grads(
        "moe_tiny", TIGHT, inputs["moe"], moe_global[0], {"dp": 2}, 2)
    images = ref.copies(inputs["images"], 2)
    for name, accum in (("resnet_dp2", 1), ("resnet_dp2_accum2", 2)):
        out[name] = ref.jax_steps(
            "resnet_tiny", {}, {"dp": 2}, inputs["resnet"]["params"], images,
            _runtime("resnet_tiny", dataset="imagenet_synthetic"),
            accum=accum, state0=inputs["resnet"]["state"])
    for name in ("dp2", "fsdp2"):
        out[f"dense_{name}"] = _jax_forward({name[:-1]: 2}, DENSE,
                                            inputs["moe"], inputs["tokens"])
    for name, axes in ADAFACTOR_MESHES.items():
        world = int(np.prod(list(axes.values())))
        out[f"adafactor_{name}"] = ref.jax_steps(
            "llama_tiny", {}, axes, inputs["llama"],
            ref.copies(inputs["llama_rows"], world),
            _runtime("llama_tiny", **ADAFACTOR))
    out["adafactor", "grads"] = ref.jax_grads(
        "llama_tiny", {}, inputs["llama"], inputs["llama_rows"][0])
    grads = ref.jax_grads("llama_tiny", {"n_layers": 4},
                          ref.lora_params(inputs["lora_base"],
                                          inputs["lora"]),
                          inputs["llama_rows"][0], lora=inputs["lora"])
    # The step donates its state: the parameters go in fresh.
    out["lora_pp2"] = ref.jax_steps(
        "llama_tiny", PP, {"dp": 1, "pp": 2},
        ref.lora_params(inputs["lora_base"], inputs["lora"]),
        inputs["llama_rows"][:2], _runtime("llama_tiny"),
        lora=inputs["lora"])
    out["lora_pp2", "grads"] = {k: v for k, v in grads.items()
                                if k.startswith("lora/")
                                and "/_meta/" not in k}
    return out


def test_moe_microbatches_are_the_global_batchs(gangs, reference):
    ranks = gangs[2].result()
    want = reference["moe_accum"]
    for r in ranks:
        got = r["moe_accum"]
        ref.assert_matches(got, want, reference["moe_accum", "grads"])
        np.testing.assert_allclose(got["router_aux"], want["router_aux"],
                                   rtol=ref.LOSS_RTOL)
    # Each rank's rows cut as they stand make other dispatch groups.
    as_cut = ranks[0]["moe_accum_as_cut"]["loss"]
    assert abs(as_cut[0] - want["loss"][0]) > 1e-4


@pytest.mark.parametrize("name", ["dp2", "fsdp2"])
def test_dense_dispatch_counts_the_global_batch(name, gangs, reference):
    ranks = gangs[2].result()
    logits = np.concatenate([r[f"dense_{name}"]["logits"] for r in ranks])
    want_logits, want_aux = reference[f"dense_{name}"]
    np.testing.assert_allclose(logits, want_logits, atol=1e-5, rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r[f"dense_{name}"]["aux"], want_aux,
                                   rtol=ref.LOSS_RTOL)


@pytest.mark.parametrize("name", list(INIT_MESHES))
def test_each_rank_draws_only_its_shards(name, gangs):
    from polyaxon_tpu_torch.models import llama as tllama

    ranks = gangs[4].result()
    cfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"], n_layers=4)
    whole = tllama.init(cfg, torch.Generator().manual_seed(0),
                        device="cpu")["params"]
    flat = ref.flat(jax.tree.map(lambda t: t.numpy(), whole))
    D, F_, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    # The largest slab: one layer of w_gate ([D, F] f32), the embedding
    # or the head ([V, D] f32); a stacked leaf whole is L of them.
    largest_slab = max(D * F_, cfg.vocab_size * D) * 4
    assert L * D * F_ * 4 > largest_slab
    for r in ranks:
        got = r[f"init_{name}"]
        assert got["local_bytes"] == got["shard_bytes"]
        assert got["largest"] <= largest_slab, got["largest"]
        assert set(got["params"]) == set(flat)
        for key, want in flat.items():
            np.testing.assert_array_equal(got["params"][key], want,
                                          err_msg=key)


@pytest.mark.parametrize("name", list(ADAFACTOR_MESHES))
def test_adafactor_over_sharded_leaves(name, gangs, reference):
    world = int(np.prod(list(ADAFACTOR_MESHES[name].values())))
    ranks = gangs[world].result()
    want = reference[f"adafactor_{name}"]
    for r in ranks:
        got = r[f"adafactor_{name}"]
        ref.assert_matches(got, want, reference["adafactor", "grads"])
        for key, value in got["params"].items():
            ref.assert_leaf_close(value, want["params"][key], 1e-4, key)


@pytest.mark.parametrize("name", ["resnet_dp2", "resnet_dp2_accum2"])
def test_batch_statistics_across_ranks(name, gangs, reference):
    ranks = gangs[2].result()
    want = reference[name]
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=ref.LOSS_RTOL)
        assert set(got["state"]) == set(want["state"])
        for key, value in want["state"].items():
            np.testing.assert_allclose(got["state"][key], value, atol=1e-5,
                                       rtol=1e-5, err_msg=key)
            np.testing.assert_array_equal(got["state"][key],
                                          ranks[0][name]["state"][key])


def test_lora_under_pp_matches_jax(gangs, reference):
    ranks = gangs[2].result()
    for r in ranks:
        ref.assert_matches(r["lora_pp2"], reference["lora_pp2"],
                           reference["lora_pp2", "grads"])
