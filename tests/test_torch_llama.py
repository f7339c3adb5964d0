"""The port's Llama serving subset against the JAX package, on the CPU.

JAX parameters (f32, from ``jax.random.key(0)``) move to the port as
numpy arrays through ``params_from_numpy``; token ids come from numpy
seeds. Both sides compute in f32. Logits agree to 1e-4: the two
libraries sum the same f32 products in different orders across two
layers and a 256-way vocabulary projection. KV agrees to 1e-5 (one
projection and a rope per element).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu_torch.models import llama as tllama


def _np(x):
    return np.asarray(x, np.float32)


def _pair(name, **overrides):
    jcfg = dataclasses.replace(jllama.CONFIGS[name], dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(tllama.CONFIGS[name], dtype=torch.float32,
                               **overrides)
    jparams = jllama.init(jcfg, jax.random.key(0))["params"]
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tllama.params_from_numpy(tcfg, tree,
                                                         device="cpu")


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


class TestWeights:
    def test_transfer_is_an_identity_map(self):
        _, jparams, _, tparams = _pair("llama_tiny")
        jflat, tflat = dict(_flat(jparams)), dict(_flat(tparams))
        assert set(jflat) == set(tflat)
        for key, value in jflat.items():
            assert tuple(tflat[key].shape) == value.shape, key
            np.testing.assert_array_equal(tflat[key].numpy(), _np(value))

    def test_serving_dtypes(self):
        """Matrices take the serving dtype, norm gains stay f32."""
        cfg = tllama.CONFIGS["llama_tiny"]
        params = tllama.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu", param_dtype=cfg.dtype)["params"]
        assert params["layers"]["wq"].dtype == torch.bfloat16
        assert params["layers"]["attn_norm"].dtype == torch.float32
        assert params["final_norm"].dtype == torch.float32
        assert tuple(params["lm_head"].shape) == (64, 256)

    def test_rejects_wrong_tree(self):
        cfg = tllama.CONFIGS["llama_tiny"]
        with pytest.raises(ValueError, match="keys"):
            tllama.params_from_numpy(cfg, {"embed": np.zeros((2, 2))},
                                     device="cpu")


class TestForward:
    @pytest.mark.parametrize("name", ["llama_tiny", "llama_tiny_tied",
                                      "gemma_tiny"])
    def test_logits_match(self, name):
        jcfg, jparams, tcfg, tparams = _pair(name)
        tokens = np.random.default_rng(0).integers(0, 256, (2, 11))
        want = jllama.forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32))
        got = tllama.forward(tcfg, tparams, torch.from_numpy(tokens))
        np.testing.assert_allclose(got.numpy(), _np(want),
                                   atol=1e-4, rtol=1e-4)


class TestPagedSurface:
    @pytest.mark.parametrize("impl", ["auto", "gather"])
    def test_prefill_insert_decode(self, impl):
        """paged_prefill_kv → paged_insert_prefill → decode_step_paged
        over non-contiguous pages, an idle row and a page-boundary
        crossing: logits and the whole cache against JAX."""
        jcfg, jparams, tcfg, tparams = _pair("llama_tiny")
        tcfg = dataclasses.replace(tcfg, paged_attention_impl=impl)
        page, n_pages, maxp = 4, 8, 8
        prompt = np.random.default_rng(1).integers(0, 256, (1, 7))
        tables = np.full((2, maxp), -1, np.int32)
        tables[0, :2] = [5, 2]

        jcache = jllama.paged_init_cache(jcfg, n_pages, page)
        k, v = jllama.paged_prefill_kv(jcfg, jparams,
                                       jnp.asarray(prompt[:, :-1]))
        jcache = jllama.paged_insert_prefill(jcache, k, v,
                                             jnp.asarray(tables[0]), page)
        tcache = tllama.paged_init_cache(tcfg, n_pages, page, device="cpu")
        tk, tv = tllama.paged_prefill_kv(tcfg, tparams,
                                         torch.from_numpy(prompt[:, :-1]))
        np.testing.assert_allclose(tk.numpy(), _np(k), atol=1e-5, rtol=1e-5)
        tllama.paged_insert_prefill(tcache, tk, tv,
                                    torch.from_numpy(tables[0]), page)

        cur = np.array([prompt[0, -1], 0])
        pos = np.array([prompt.shape[1] - 1, -1])
        for _ in range(4):  # crosses the pos=8 page boundary
            if tables[0, pos[0] // page] < 0:
                tables[0, pos[0] // page] = 6
            want, jcache = jllama.decode_step_paged(
                jcfg, jparams, jcache, jnp.asarray(cur, jnp.int32),
                jnp.asarray(pos, jnp.int32), jnp.asarray(tables))
            got, tcache = tllama.decode_step_paged(
                tcfg, tparams, tcache, torch.from_numpy(cur),
                torch.from_numpy(pos), torch.from_numpy(tables).long())
            np.testing.assert_allclose(got[0].numpy(), _np(want[0]),
                                       atol=1e-4, rtol=1e-4)
            cur = np.array([int(np.argmax(_np(want[0]))), 0])
            pos[0] += 1
        # Scratch page 0 holds idle-row garbage on both sides; every real
        # page must agree.
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key][:, 1:].numpy(),
                                       _np(jcache[key])[:, 1:],
                                       atol=1e-5, rtol=1e-5)

    def test_suffix_prefill(self):
        """The radix-hit suffix prefill: a 5-token suffix after a cached
        6-token prefix (two 4-token pages, the second half-used), padded
        to a bucket of 8 with the tail routed to scratch."""
        jcfg, jparams, tcfg, tparams = _pair("llama_tiny")
        page = 4
        tokens = np.random.default_rng(2).integers(0, 256, (1, 11))
        page_ids = np.array([3, 1, 6, 2, -1, -1], np.int32)
        m, real = 6, 5
        suffix = np.zeros((1, 8), np.int64)
        suffix[0, :real] = tokens[0, m:]

        jcache = jllama.paged_init_cache(jcfg, 8, page)
        k, v = jllama.paged_prefill_kv(jcfg, jparams,
                                       jnp.asarray(tokens[:, :m]))
        jcache = jllama.paged_insert_prefill(jcache, k, v,
                                             jnp.asarray(page_ids), page)
        tcache = tllama.paged_init_cache(tcfg, 8, page, device="cpu")
        tk, tv = tllama.paged_prefill_kv(tcfg, tparams,
                                         torch.from_numpy(tokens[:, :m]))
        tllama.paged_insert_prefill(tcache, tk, tv,
                                    torch.from_numpy(page_ids), page)

        pref = np.maximum(page_ids[:2], 0)
        jkp = jcache["k"][:, pref].reshape(2, 2 * page, 2, 16)
        jvp = jcache["v"][:, pref].reshape(2, 2 * page, 2, 16)
        jks, jvs = jllama.paged_prefill_suffix_kv(
            jcfg, jparams, jnp.asarray(suffix, jnp.int32), jkp, jvp,
            jnp.int32(m))
        jcache = jllama.paged_insert_suffix(
            jcache, jks, jvs, jnp.asarray(page_ids), jnp.int32(m), page,
            jnp.int32(real))

        tpref = torch.from_numpy(pref).long()
        tkp = tcache["k"][:, tpref].flatten(1, 2)
        tvp = tcache["v"][:, tpref].flatten(1, 2)
        tks, tvs = tllama.paged_prefill_suffix_kv(
            tcfg, tparams, torch.from_numpy(suffix), tkp, tvp, m)
        np.testing.assert_allclose(tks[:, :real].numpy(),
                                   _np(jks)[:, :real], atol=1e-5, rtol=1e-5)
        tllama.paged_insert_suffix(tcache, tks, tvs,
                                   torch.from_numpy(page_ids), m, page, real)
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key][:, 1:].numpy(),
                                       _np(jcache[key])[:, 1:],
                                       atol=1e-5, rtol=1e-5)

    def test_refuses_sliding_window(self):
        cfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"],
                                  sliding_window=8)
        with pytest.raises(ValueError, match="sliding_window"):
            tllama.paged_init_cache(cfg, 4, 4, device="cpu")

    def test_admission_rules(self):
        assert tllama.cb_admission([4, 5, 6]) == (2, 6, [4, 5])
        assert tllama.cb_admission([4]) == (0, 4, None)
        with pytest.raises(ValueError, match="max_len"):
            tllama.cb_validate(None, 10, 10, 16)
