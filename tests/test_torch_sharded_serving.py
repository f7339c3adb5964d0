"""Sharded serving (``serving/gang.py``): the port's ``ServingServer``
over a mesh of gloo processes, held against the JAX package's
``ServingServer(mesh_axes=...)`` on its CPU mesh, on the same f32
weights (the port reads them from a checkpoint in its store, each rank
cutting its shards as it reads; the JAX server is handed them through
its ``load_params``, placed by its rules).

For each case the greedy tokens of two rows equal the JAX server's on
the same mesh: llama_tiny static and continuous-paged at tp2, at tp4
(2 KV heads over 4 ranks: each rank's cache holds the group its query
heads read) and at dp2 x tp2; ``fsdp: -1`` continuous (the reference's
``test_fsdp_all_devices_continuous`` pair); moe_tiny at tp2; t5_tiny
continuous at fsdp2; int8 at tp2; a draft model at tp2 (the static
engine's speculation); a streamed request at tp2 equal to the
non-streamed one. At tp2 the sharded prefill's logits and its first
decode step's agree with JAX's prefill and decode step to 2e-4. Every
rank holds its shards only, and runs the model calls rank 0 sends.
A serving mesh with cp, sp, ep or pp above 1 is placed by the same
rules (those gangs serve in ``tests/test_torch_serving_meshes.py``), and
``--mesh`` parses as the JAX CLI parses it.
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
# The reference's fsdp pair (tests/test_serving.py).
FSDP_ROWS = {"tokens": [[5, 6, 7], [1, 2, 3, 4]], "max_new_tokens": 5}
PAGED = {"batching": "continuous", "kv": "paged", "slots": 2}
MODELS = ("llama_tiny", "moe_tiny", "t5_tiny")
# name: (world, model, axes, server options, requests)
CASES = {
    "tp2": (2, "llama_tiny", {"tp": 2}, {}, ROWS),
    "tp2_paged": (2, "llama_tiny", {"tp": 2}, PAGED, ROWS),
    "tp4": (4, "llama_tiny", {"tp": 4}, {}, ROWS),
    "tp4_paged": (4, "llama_tiny", {"tp": 4}, PAGED, ROWS),
    "dp2xtp2": (4, "llama_tiny", {"dp": 2, "tp": 2}, {}, ROWS),
    "dp2xtp2_paged": (4, "llama_tiny", {"dp": 2, "tp": 2}, PAGED, ROWS),
    "fsdp_all": (4, "llama_tiny", {"fsdp": -1},
                 {"batching": "continuous", "slots": 2}, FSDP_ROWS),
    "moe_tp2": (2, "moe_tiny", {"tp": 2}, {}, ROWS),
    "t5_fsdp2": (2, "t5_tiny", {"fsdp": 2},
                 {"batching": "continuous", "slots": 2}, ROWS),
    "int8_tp2": (2, "llama_tiny", {"tp": 2}, {"quantize": "int8"}, ROWS),
    "draft_tp2": (2, "llama_tiny", {"tp": 2},
                  {"draft_model": "llama_tiny", "spec_k": 3}, ROWS),
}
# Meshes the gang once refused; every one is served now.
REFUSED = ({"cp": 2}, {"sp": 2}, {"ep": 2}, {"pp": 2}, {"tp": 2, "ep": 2})


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


@pytest.fixture(scope="module")
def gangs(weights):
    """The 2-rank and 4-rank gangs, started in threads while JAX
    serves."""
    from concurrent.futures import ThreadPoolExecutor

    by_world: dict = {}
    for name, (world, model, axes, server, rows) in CASES.items():
        server = dict(server)
        if "draft_model" in server:
            server["draft_checkpoint"] = weights[model][1]
        requests = {"plain": rows}
        case = {"name": name, "model": model, "axes": axes, "f32": [model],
                "checkpoint": weights[model][1], "server": server,
                "requests": requests}
        if name == "tp2":
            case["logits"] = ROWS["tokens"][1]
        if name == "tp2_paged":
            requests["stream"] = rows
        by_world.setdefault(world, []).append(case)
    pool = ThreadPoolExecutor(len(by_world))
    futures = {w: pool.submit(torch_dist.run, serving_cases, w, cases)
               for w, cases in by_world.items()}
    yield futures
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
    places the same weights by the mesh's rules, as it places a
    checkpoint's), and its prefill and first decode step's logits."""
    from polyaxon_tpu.models import llama as jllama
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
        for name, (_, model, axes, server, rows) in CASES.items():
            with jserver.ServingServer(model, seed=0, mesh_axes=axes,
                                       **server) as s:
                out[name] = _post(s.url, rows)
        cfg = jllama.CONFIGS["llama_tiny"]
        params = jax.tree.map(jnp.asarray, weights["llama_tiny"][0])
        prompt = jnp.asarray([ROWS["tokens"][1]], jnp.int32)
        logits, cache = jllama.prefill(cfg, params, prompt, 32)
        step, _ = jllama.decode_step(cfg, params, cache,
                                     jnp.argmax(logits, -1).astype(
                                         jnp.int32), prompt.shape[1])
        out["logits"] = (np.asarray(logits), np.asarray(step))
    finally:
        patch.undo()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_tokens_equal_the_jax_server(name, gangs, reference):
    world = CASES[name][0]
    ranks = gangs[world].result()
    assert ranks[0][name]["plain"] == reference[name]
    # Every rank ran every model call rank 0 made.
    assert len({r[name]["calls"] for r in ranks}) == 1
    assert ranks[0][name]["calls"] > 0


def test_sharded_logits_match_jax(gangs, reference):
    got = gangs[2].result()[0]["tp2"]
    want_prefill, want_step = reference["logits"]
    np.testing.assert_allclose(got["prefill_logits"], want_prefill,
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["decode_logits"], want_step, atol=2e-4,
                               rtol=0)


def test_streamed_request_equals_the_plain_one(gangs):
    got = gangs[2].result()[0]["tp2_paged"]
    assert got["stream"] == got["plain"]


@pytest.mark.parametrize("name", ["tp2", "tp4", "fsdp_all", "dp2xtp2"])
def test_each_rank_holds_its_shards(name, gangs, weights):
    """A rank's weights are its shards of the model's: 1/tp (1/fsdp) of
    each sharded leaf, the replicated ones whole."""
    world, model, axes, _, _ = CASES[name]
    ranks = gangs[world].result()
    whole = sum(v.nbytes for v in jax.tree.leaves(weights[model][0]))
    split = int(np.prod([n for a, n in axes.items() if a != "dp"])) \
        if -1 not in axes.values() else world
    for r in ranks:
        assert whole / split <= r[name]["param_bytes"] < whole


@pytest.mark.parametrize("axes", REFUSED, ids=str)
def test_unserved_axes_raise_naming_7d(axes):
    """These meshes place moe_tiny for serving as the reference's rules
    do: its experts split over ep, and each rank's other leaves are its
    tp shards or whole; on one process the server fails only for want of
    the mesh's ranks."""
    from polyaxon_tpu.models import moe as jmoe
    from polyaxon_tpu.parallel import rules_for_mesh as jrules
    from polyaxon_tpu.parallel.sharding import tree_shardings
    from polyaxon_tpu_torch.models import moe
    from polyaxon_tpu_torch.parallel.mesh import build_mesh
    from polyaxon_tpu_torch.parallel.sharding import (serving_rules,
                                                      tree_placements)
    from polyaxon_tpu_torch.serving.server import ServingServer

    world = int(np.prod(list(axes.values())))
    mesh = build_mesh(axes=axes, devices=range(world))
    cfg = moe.CONFIGS["moe_tiny"]
    pl = tree_placements(moe.logical_axes(cfg)["params"], mesh,
                         serving_rules(mesh))
    jmesh = ref.jax_mesh(axes)
    jsh = tree_shardings(jmoe.logical_axes(jmoe.CONFIGS["moe_tiny"])[
        "params"], jmesh, jrules(jmesh))

    def sharded_dims(placements):
        return sorted({p.dim for p in placements if p.is_shard()})

    for key in ("w_gate", "wq", "router"):
        spec = jsh["layers"][key].spec
        want = [d for d, e in enumerate(spec) if e is not None]
        assert sharded_dims(pl["layers"][key]) == want, key
    with pytest.raises(ValueError, match=f"require {world} chips"):
        ServingServer("llama_tiny", mesh_axes=axes, device="cpu")


@pytest.mark.parametrize("text", ["tp=4", "fsdp=-1", "tp=2,dp=-1",
                                  "model=2,data=2", "tp", "tp=x", "=2",
                                  "tp=2,tp=2"])
def test_mesh_flag_parses_as_the_jax_cli(text, monkeypatch):
    """``--mesh`` gives the server the axes JAX's ``parse_mesh_axes``
    gives, and refuses what it refuses with its message."""
    import polyaxon_tpu_torch.serving.__main__ as cli
    import polyaxon_tpu_torch.serving.server as server_mod
    from polyaxon_tpu.parallel import parse_mesh_axes as jparse

    seen = {}

    class Stop(Exception):
        pass

    def fake_server(model, checkpoint=None, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(server_mod, "ServingServer", fake_server)
    try:
        want = jparse(text)
    except ValueError as exc:
        with pytest.raises(SystemExit):
            cli.main(["--model", "llama_tiny", "--mesh", text])
        with pytest.raises(ValueError, match=str(exc).split("(")[0][:20]):
            from polyaxon_tpu_torch.parallel.mesh import parse_mesh_axes

            parse_mesh_axes(text)
        return
    with pytest.raises(Stop):
        cli.main(["--model", "llama_tiny", "--mesh", text])
    assert seen["mesh_axes"] == want
