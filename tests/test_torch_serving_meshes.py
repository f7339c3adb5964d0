"""Serving over ep, cp, sp and pp (``serving/gang.py``): the port's
``ServingServer`` over a mesh of two or four gloo processes, held
against the JAX package's ``ServingServer(mesh_axes=...)`` on its CPU
mesh and the port's own unsharded server, on the same f32 weights.

- moe_tiny at ep2, static (its decode steps take the dense dispatch,
  each rank running its two experts and the ep group summing their
  parts; its prompt pass the ragged dispatch as the JAX server computes
  it, the ``ep == 1`` function) and continuous over the paged pool;
- llama_tiny at cp2 (static), sp2 (continuous, paged) and pp2 (static;
  ``pipeline_stages=1``, as both packages serve): the rules place its
  weights whole on both ranks, which compute the same rows;
- int8 weights on four ranks: moe_tiny at tp2 x ep2 and llama_tiny at
  tp2 x cp2, where each expert's ``mlp`` and the query heads, whole over
  tp by the rules, are cut to each tp rank's share at use.

Each case's greedy tokens of two rows equal the JAX server's on the
same mesh and the port's unsharded server's; every rank runs every
model call rank 0 makes; at ep2 each rank holds half of the experts.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_dist
from tests import torch_jax_ref as ref
from tests.torch_dist_cases import serving_cases

ROWS = {"tokens": [[5, 6, 7], [9, 8, 7, 6, 5]], "max_new_tokens": 6}
PAGED = {"batching": "continuous", "kv": "paged", "slots": 2}
MODELS = ("llama_tiny", "moe_tiny")
INT8 = {"quantize": "int8"}
# name: (model, axes, server options)
CASES = {
    "moe_ep2": ("moe_tiny", {"ep": 2}, {}),
    "moe_ep2_paged": ("moe_tiny", {"ep": 2}, PAGED),
    "llama_cp2": ("llama_tiny", {"cp": 2}, {}),
    "llama_sp2_paged": ("llama_tiny", {"sp": 2}, PAGED),
    "llama_pp2": ("llama_tiny", {"pp": 2}, {}),
    # int8 weights that the rules leave whole over tp, cut to each
    # rank's share at use: each expert's mlp, the query heads.
    "moe_tp2xep2_int8": ("moe_tiny", {"ep": 2, "tp": 2}, INT8),
    "llama_tp2xcp2_int8": ("llama_tiny", {"cp": 2, "tp": 2}, INT8),
}
GANG_SECONDS = 600


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each model's f32 weights as numpy, and a checkpoint of them in the
    port's store."""
    from polyaxon_tpu_torch.runtime.checkpoint import write_tree

    out = {}
    for model in MODELS:
        params = ref.drawn_params(model, {})
        path = str(tmp_path_factory.mktemp(model))
        write_tree(path, 1, {"params": jax.tree.map(torch.from_numpy,
                                                    params)})
        out[model] = (params, path)
    return out


def _world(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


@pytest.fixture(scope="module")
def gangs(weights):
    """A gang per world size, every case of that size in it, started in
    threads while JAX serves."""
    from concurrent.futures import ThreadPoolExecutor

    by_world: dict = {}
    for name, (model, axes, server) in CASES.items():
        by_world.setdefault(_world(axes), []).append(
            {"name": name, "model": model, "axes": axes, "f32": [model],
             "checkpoint": weights[model][1], "server": server,
             "requests": {"plain": ROWS}})
    pool = ThreadPoolExecutor(len(by_world))
    yield {w: pool.submit(torch_dist.run, serving_cases, w, cases)
           for w, cases in by_world.items()}
    pool.shutdown()


def _post(url: str, payload: dict) -> list:
    req = urllib.request.Request(url + "/v1/generate", method="POST",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.load(resp)["tokens"]


@pytest.fixture(scope="module")
def reference(weights, gangs):
    """The JAX server's tokens per case (f32 configs; ``load_params``
    places the same weights by the mesh's rules)."""
    from polyaxon_tpu.serving import server as jserver
    from polyaxon_tpu.serving.server import _family

    def load_params(model, checkpoint=None, seed=0, mesh=None,
                    lora_alpha=16.0):
        family = _family(model)
        cfg = family.CONFIGS[model]
        params = jax.tree.map(jnp.asarray, weights[model][0])
        if mesh is not None:
            from polyaxon_tpu.parallel import rules_for_mesh
            from polyaxon_tpu.parallel.sharding import tree_shardings

            params = jax.device_put(params, tree_shardings(
                family.logical_axes(cfg)["params"], mesh,
                rules_for_mesh(mesh)))
        return cfg, params

    patch = pytest.MonkeyPatch()
    patch.setattr(jserver, "load_params", load_params)
    for model in MODELS:
        configs = _family(model).CONFIGS
        patch.setitem(configs, model, dataclasses.replace(
            configs[model], dtype=jnp.float32))
    out = {}
    try:
        for name, (model, axes, server) in CASES.items():
            with jserver.ServingServer(model, seed=0, mesh_axes=axes,
                                       **server) as s:
                out[name] = _post(s.url, ROWS)
    finally:
        patch.undo()
    return out


@pytest.fixture(scope="module")
def unsharded(weights):
    """The port's own server on one process, per case's model and
    options."""
    from polyaxon_tpu_torch.models import family_of
    from polyaxon_tpu_torch.serving.server import ServingServer

    patch = pytest.MonkeyPatch()
    for model in MODELS:
        configs = family_of(model).CONFIGS
        patch.setitem(configs, model, dataclasses.replace(
            configs[model], dtype=torch.float32))
    out = {}
    try:
        for name, (model, _, server) in CASES.items():
            with ServingServer(model, weights[model][1], device="cpu",
                               **server) as s:
                out[name] = _post(s.url, ROWS)
    finally:
        patch.undo()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_tokens_equal_the_jax_server_and_the_unsharded_one(
        name, gangs, reference, unsharded):
    ranks = gangs[_world(CASES[name][1])].result(timeout=GANG_SECONDS)
    got = ranks[0][name]["plain"]
    assert got == reference[name]
    assert got == unsharded[name]
    # Every rank ran every model call rank 0 made.
    assert len({r[name]["calls"] for r in ranks}) == 1
    assert ranks[0][name]["calls"] > 0


def test_ep_ranks_hold_half_of_the_experts(gangs, weights):
    """At ep2 a rank's weights are its two experts of four (and their
    router columns) beside the replicated attention, embedding and
    head; at cp2, sp2 and pp2 every rank holds the whole model."""
    ranks = gangs[2].result(timeout=GANG_SECONDS)
    moe = weights["moe_tiny"][0]
    whole = sum(v.nbytes for v in jax.tree.leaves(moe))
    experts = sum(moe["layers"][k].nbytes
                  for k in ("w_gate", "w_up", "w_down", "router"))
    for r in ranks:
        assert r["moe_ep2"]["param_bytes"] == whole - experts // 2
    llama = sum(v.nbytes for v in jax.tree.leaves(
        weights["llama_tiny"][0]))
    for r in ranks:
        for name in ("llama_cp2", "llama_sp2_paged", "llama_pp2"):
            assert r[name]["param_bytes"] == llama


def test_pipelined_decode_is_refused_alike():
    """Serving over pp means unpipelined layers: a config with
    ``pipeline_stages`` above 1 refuses a decode surface's explicit
    positions, as the reference's does."""
    from polyaxon_tpu.models import llama as jllama
    from polyaxon_tpu_torch.models import llama as tllama
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh

    jcfg = dataclasses.replace(jllama.CONFIGS["llama_tiny"],
                               pipeline_stages=2)
    tcfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"],
                               pipeline_stages=2, dtype=torch.float32)
    positions = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="contiguous positions"):
        jllama.forward(jcfg, {}, jnp.zeros((1, 4), jnp.int32),
                       jnp.asarray(positions))
    with use_mesh(build_mesh(axes={"pp": 2}, devices=range(2))):
        with pytest.raises(ValueError, match="contiguous positions"):
            tllama.forward(tcfg, {}, torch.zeros((1, 4), dtype=torch.long),
                           torch.from_numpy(positions))
