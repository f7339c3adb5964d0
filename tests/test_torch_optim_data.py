"""The port's lion and adafactor, the non-LM datasets and the HF Llama
converter, against the JAX package (and optax) on the CPU.

- Optimizers: four updates (a warmup step at lr 0, then a cosine
  schedule; with and without global-norm clipping) of a tree that holds
  adafactor's factored leaves (two dims of at least 128, a stacked
  3-D one included) and unfactored ones (a vector, a small matrix), to
  atol 1e-6, rtol 1e-5 (the same f32 elementwise arithmetic; adafactor's
  row means are taken in another order).
- Datasets: batches byte-identical to the JAX generators', resumed at a
  batch index.
- Converter: a synthetic HF state dict through both packages' converters,
  equal arrays, and back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.runtime import data as jdata
from polyaxon_tpu_torch.runtime import data as tdata
from polyaxon_tpu_torch.runtime import optim as toptim
from polyaxon_tpu_torch.runtime.config import RuntimeConfig

torch.set_num_threads(1)


def _tree(rng):
    return {"factored": rng.standard_normal((130, 200)).astype(np.float32),
            "stacked": rng.standard_normal((3, 128, 160)).astype(np.float32),
            "small": rng.standard_normal((4, 3)).astype(np.float32),
            "bias": {"v": rng.standard_normal(5).astype(np.float32)}}


@pytest.mark.parametrize("clip", [None, 1e-3], ids=["noclip", "clipped"])
@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_updates_match_optax(name, clip):
    from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
    from polyaxon_tpu.runtime.optim import build_optimizer as jbuild

    spec = dict(model="x", optimizer=name, grad_clip_norm=clip,
                learning_rate=0.1, lr_schedule="cosine", warmup_steps=1,
                weight_decay=0.1, steps=10)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt = jbuild(JCfg(**spec))
    update = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = toptim.build_optimizer(RuntimeConfig.from_dict(spec))
    tp = jax.tree.map(torch.tensor, params)
    tstate = topt.init(tp)
    if name == "adafactor":
        # Leaves in key order (bias, factored, small, stacked): factored
        # row/column moments for the big ones (the two largest dims, the
        # rows over the largest), a full one for the rest, as optax's
        # min_dim_size_to_factor=128 decides.
        assert [tuple(v.shape) for v in tstate["v_row"]] == [
            (1,), (130,), (1,), (3, 128)]
        assert [tuple(v.shape) for v in tstate["v_col"]] == [
            (1,), (200,), (1,), (3, 160)]
        assert [tuple(v.shape) for v in tstate["v"]] == [
            (5,), (1,), (4, 3), (1,)]
    for step in range(4):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            params)
        upd, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, [torch.tensor(g) for g in toptim.tree_leaves(grads)],
                    tstate)
        for w, g in zip(jax.tree.leaves(jp), toptim.tree_leaves(tp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-5, err_msg=f"step {step}")


@pytest.mark.parametrize("name,kwargs", [
    ("seq2seq_synthetic", dict(seq_len=24, vocab_size=500)),
    ("mlm_synthetic", dict(seq_len=24, vocab_size=500, mask_rate=0.3)),
    ("imagenet_synthetic", dict(image_size=16, num_classes=7)),
    ("image_synthetic", dict(image_size=8)),
    ("mnist_synthetic", {}),
])
def test_datasets_are_byte_identical(name, kwargs):
    kw = dict(batch_size=3, seed=5, start_batch=2, **kwargs)
    jit, tit = jdata.get_dataset(name, **kw), tdata.get_dataset(name, **kw)
    for _ in range(2):
        a, b = next(jit), next(tit)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), key
    assert tdata.dataset_for_model("t5_base") == "seq2seq_synthetic"


def test_convert_round_trip_matches_jax():
    """A synthetic HF LlamaForCausalLM state dict (torch tensors, bf16
    among them) through both converters, and back to HF names."""
    import dataclasses

    from polyaxon_tpu.models import convert as jconvert
    from polyaxon_tpu.models import llama as jllama
    from polyaxon_tpu_torch.models import convert as tconvert
    from polyaxon_tpu_torch.models.llama import CONFIGS as TCONFIGS

    jcfg = dataclasses.replace(jllama.CONFIGS["llama_tiny"], n_layers=2)
    tcfg = dataclasses.replace(TCONFIGS["llama_tiny"], n_layers=2)
    from polyaxon_tpu_torch.models import llama as tllama

    params = tllama.init(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")["params"]
    want = jconvert.to_hf_llama(jax.tree.map(lambda t: t.numpy(), params),
                                jcfg)
    sd = {k: torch.tensor(v) for k, v in want.items()}
    sd["model.norm.weight"] = sd["model.norm.weight"].to(torch.bfloat16)
    jtree = jconvert.from_hf_llama(sd, jcfg)["params"]
    ttree = tconvert.from_hf_llama(sd, tcfg)["params"]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    assert len(flat_j) == 12
    for path, value in flat_j.items():
        keys = [p.key for p in path]
        got = ttree
        for key in keys:
            got = got[key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(value))
    back = tconvert.to_hf_llama(ttree, tcfg)
    assert sorted(back) == sorted(want)
    for key, value in back.items():
        assert value.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(value, np.asarray(
            sd[key].float().numpy()))
    with pytest.raises(ValueError, match="more than"):
        tconvert.from_hf_llama(sd, dataclasses.replace(tcfg, n_layers=1))
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="up_proj"):
        tconvert.from_hf_llama(sd, tcfg)
