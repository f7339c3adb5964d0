"""The Orbax converter (``scripts/convert_orbax_to_torch.py`` over
``polyaxon_tpu_torch.models.convert.params_to_store``), on the CPU.

``llama_tiny`` params drawn by the JAX package (f32, ``jax.random.key``)
are saved with the JAX package's ``CheckpointManager`` as a train state
(with an adamw optimizer state and a step), as a bare ``{"params"}``
tree, and as a LoRA fine-tune's state (``{"base", "lora"}`` with its
``_meta``), then converted into the port's store:

- the converted leaves are bitwise the JAX f32 params, in one committed
  step whose manifest CRC-32s ``load_tree`` checks;
- ``load_params(..., checkpoint=out, device="cpu")`` returns those f32
  params cast as the port serves them (matrices in the config's bf16,
  norm gains f32), bitwise; the JAX package's ``load_params`` returns
  the f32 params themselves from the Orbax directory. The port's
  forward over the served weights gives the JAX forward's logits over
  the same weights to 1e-5 of the largest logit (both in f32; the
  libraries sum in different orders);
- the LoRA state is merged at load as the reference's ``cli/main.py
  convert --from-orbax`` export merges it: the port's merged f32 tree,
  in HF layout, equals the export's safetensors to 1e-6 relative (a
  rank-4 f32 product summed in another order);
- a tree whose shapes differ from the model's, and an output directory
  that already holds a step, are refused (the CLI exits 1).

Optimizer state is not converted (ROADMAP.md, Queue 1 item 3c).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.models import lora as jlora
from polyaxon_tpu.polyflow.runs import V1JaxCheckpointing
from polyaxon_tpu.runtime.checkpoint import CheckpointManager
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.runtime import checkpoint as ck
from polyaxon_tpu_torch.serving.server import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "llama_tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bridge():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_to_torch",
        os.path.join(REPO, "scripts", "convert_orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jparams():
    cfg = dataclasses.replace(jllama.CONFIGS[MODEL], dtype=jnp.float32)
    return jllama.init(cfg, jax.random.key(0))["params"]


def save_orbax(directory, state, step=3):
    mgr = CheckpointManager(str(directory), V1JaxCheckpointing(
        enabled=True, async_save=False))
    try:
        mgr.save(step, state, force=True)
        mgr.wait()
    finally:
        mgr.close()
    return str(directory)


def flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


@pytest.mark.parametrize("layout", ["train_state", "bare"])
def test_converted_params_are_bitwise_and_serve_the_jax_logits(
        tmp_path, bridge, jparams, layout):
    from polyaxon_tpu.serving.server import load_params as jload_params

    if layout == "train_state":
        state = {"params": jparams,
                 "opt_state": optax.adamw(1e-3).init(jparams),
                 "step": jnp.int32(3)}
    else:
        state = {"params": jparams}
    orbax_dir = save_orbax(tmp_path / "orbax", state)
    out = str(tmp_path / "torch")
    step, written = bridge.convert(MODEL, orbax_dir, out)
    assert (step, written) == (3, os.path.join(out, "3"))
    manifest = ck.read_manifest(out, 3)
    assert all(e["path"].startswith("params/") and "crc32" in e
               for e in manifest["leaves"])

    _, tree = ck.load_tree(out)
    stored = dict(flat(tree["params"]))
    want = dict(flat(jparams))
    assert set(stored) == set(want)
    for path, value in want.items():
        assert stored[path].dtype == torch.float32, path
        np.testing.assert_array_equal(as_numpy(stored[path]),
                                      np.asarray(value), err_msg=path)

    cfg, served = load_params(MODEL, checkpoint=out, device="cpu")
    _, jserved = jload_params(MODEL, checkpoint=orbax_dir)
    jflat = dict(flat(jserved))
    for path, value in flat(served):
        np.testing.assert_array_equal(np.asarray(jflat[path]),
                                      np.asarray(want[path]), err_msg=path)
        assert value.dtype == (torch.float32 if path.endswith("norm")
                               else cfg.dtype), path
        cast = torch.from_numpy(np.array(want[path])).to(value.dtype)
        assert torch.equal(value, cast), path

    tokens = np.random.default_rng(0).integers(0, 256, (2, 11))
    f32 = torch.float32
    tparams = {k: ({n: w.to(f32) for n, w in v.items()}
                   if isinstance(v, dict) else v.to(f32))
               for k, v in served.items()}
    got = tllama.forward(dataclasses.replace(cfg, dtype=f32), tparams,
                         torch.from_numpy(tokens)).numpy()
    jcfg = dataclasses.replace(jllama.CONFIGS[MODEL], dtype=jnp.float32)
    jweights = jax.tree.map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
        if x.ndim > 1 else x, jparams)
    want_logits = np.asarray(jllama.forward(
        jcfg, jweights, jnp.asarray(tokens, jnp.int32)))
    scale = np.abs(want_logits).max()
    assert np.abs(got - want_logits).max() <= 1e-5 * scale


def test_lora_state_merges_as_the_reference_export(tmp_path, bridge,
                                                   jparams):
    from safetensors.numpy import load_file

    from polyaxon_tpu.cli.main import _export_to_hf
    from polyaxon_tpu_torch.models.convert import to_hf_llama
    from polyaxon_tpu_torch.models.lora import merge_saved

    lora = jlora.init_lora(jparams, 4, ("wq", "wv", "w_down"),
                           jax.random.key(1))
    # Non-zero B, so the merge changes every adapted weight.
    rng = np.random.default_rng(2)
    lora = {k: {"a": v["a"], "b": jnp.asarray(
        rng.standard_normal(v["b"].shape).astype(np.float32) * 0.1)}
        for k, v in lora.items()}
    state = {"params": {"base": jparams,
                        "lora": jlora.with_meta(lora, 4, 8.0)},
             "step": jnp.int32(5)}
    orbax_dir = save_orbax(tmp_path / "orbax", state, step=5)
    out = str(tmp_path / "torch")
    bridge.convert(MODEL, orbax_dir, out)

    export = str(tmp_path / "hf")
    _export_to_hf(MODEL, jllama.CONFIGS[MODEL], orbax_dir, export)
    reference = load_file(os.path.join(export, "model.safetensors"))

    _, tree = ck.load_tree(out)
    saved = tree["params"]
    assert set(saved) == {"base", "lora"}
    assert float(saved["lora"]["_meta"]["alpha"]) == 8.0
    merged = merge_saved(saved["base"], saved["lora"])
    ours = to_hf_llama(merged, tllama.CONFIGS[MODEL])
    assert set(ours) == set(reference)
    for key, value in reference.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-6, atol=1e-7,
                                   err_msg=key)

    cfg, served = load_params(MODEL, checkpoint=out, device="cpu")
    for path, value in flat(served):
        want = dict(flat(merged))[path].to(value.dtype)
        assert torch.equal(value, want), path


def test_mismatched_tree_and_existing_output_are_refused(tmp_path, bridge,
                                                         jparams):
    bad = dict(jparams, embed=jparams["embed"][:, :32])
    orbax_dir = save_orbax(tmp_path / "orbax", {"params": bad})
    out = str(tmp_path / "torch")
    with pytest.raises(ValueError, match="/embed has shape"):
        bridge.convert(MODEL, orbax_dir, out)
    assert ck._list_store_steps(out) == []
    assert bridge.main(["--model", MODEL, "--orbax", orbax_dir,
                        "--out", out]) == 1
    assert bridge.main(["--model", "llama_tiny_tied", "--orbax",
                        save_orbax(tmp_path / "good", {"params": jparams}),
                        "--out", out]) == 1  # lm_head is not in the tree

    good = str(tmp_path / "good")
    converted = str(tmp_path / "torch_good")
    assert bridge.main(["--model", MODEL, "--orbax", good,
                        "--out", converted]) == 0
    assert ck._list_store_steps(converted) == [3]
    with pytest.raises(FileExistsError, match="step 3"):
        bridge.convert(MODEL, good, converted)
