"""Port numerics and kernel modules against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; every
comparison is in f32. Tolerances: 1e-5 where both sides run the same
f32 arithmetic in another order; 2e-5 for attention, whose softmax sums
over up to 256 columns in different orders (blocked online softmax in
the Pallas interpreter against one pass in the port).
"""

import ast
import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import common as jcommon
from polyaxon_tpu.ops import attention as jattn
from polyaxon_tpu.ops import flash as jflash
from polyaxon_tpu.ops import paged_attention as jpaged
from polyaxon_tpu_torch.models import common as tcommon
from polyaxon_tpu_torch.ops import attention as tattn
from polyaxon_tpu_torch.ops import flash as tflash
from polyaxon_tpu_torch.ops import paged_attention as tpaged

LLAMA31 = {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
           "original_max_position_embeddings": 8192}


def _np(x):
    return np.asarray(x, np.float32)


def _qkv(rng, B, S, H, KV, D, sk=None):
    sk = sk or S
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, sk, KV, D)).astype(np.float32))


class TestCommon:
    @pytest.mark.parametrize("scaling", [None, LLAMA31])
    def test_rope(self, scaling):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
        pos = rng.integers(0, 20000, (2, 7)).astype(np.int32)
        want = jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0,
                            scaling)
        got = tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos),
                           500_000.0, scaling)
        # Angles reach 2e4 rad: f32 trig differs between the two
        # libraries in the last bits of large arguments.
        np.testing.assert_allclose(got.numpy(), _np(want),
                                   atol=2e-4, rtol=1e-4)

    @pytest.mark.parametrize("offset", [0.0, 1.0])
    def test_rms_norm(self, offset):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((3, 5, 32)).astype(np.float32)
        w = rng.standard_normal(32).astype(np.float32)
        want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                offset=offset)
        got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                               1e-6, offset=offset)
        np.testing.assert_allclose(got.numpy(), _np(want),
                                   atol=1e-5, rtol=1e-5)

    def test_sample_row_filters(self):
        """top_k=1 and a tiny top_p both leave only the argmax."""
        logits = torch.tensor([0.1, 3.0, 0.2, 2.9])
        gen = torch.Generator().manual_seed(0)
        for top_p, top_k in ((1.0, 1), (1e-3, 0)):
            tok = tcommon.sample_row(logits, gen, 1.0, top_p, top_k)
            assert int(tok) == 1


class TestAttention:
    @pytest.mark.parametrize("kwargs", [
        {"causal": True},
        {"causal": False},
        {"causal": True, "window": 5},
        {"causal": True, "segments": True},
    ], ids=["causal", "full", "window", "segments"])
    def test_xla_attention_with_lse(self, kwargs):
        rng = np.random.default_rng(2)
        q, k, v = _qkv(rng, 2, 12, 4, 2, 16)
        seg = None
        if kwargs.pop("segments", False):
            seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]], np.int32), 4,
                            axis=1)
        jo, jl = jattn.xla_attention_with_lse(
            *map(jnp.asarray, (q, k, v)),
            segment_ids=None if seg is None else jnp.asarray(seg), **kwargs)
        to, tl = tattn.xla_attention_with_lse(
            *map(torch.from_numpy, (q, k, v)),
            segment_ids=None if seg is None else torch.from_numpy(seg),
            **kwargs)
        np.testing.assert_allclose(to.numpy(), _np(jo), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-5, rtol=1e-5)

    def test_dispatch_rules(self):
        q = torch.zeros(1, 4, 2, 8)
        with pytest.raises(ValueError, match="require"):
            tattn.dot_product_attention(q, q, q, impl="xla", block_q=64)
        for impl in ("ring", "ulysses"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                tattn.dot_product_attention(q, q, q, impl=impl)
        with pytest.raises(ValueError, match="Unknown"):
            tattn.dot_product_attention(q, q, q, impl="bogus")
        # "auto" on CPU tensors is the einsum path, knobs tolerated.
        got = tattn.dot_product_attention(q, q, q, impl="auto", block_q=64)
        assert got.shape == q.shape


class TestFlash:
    @pytest.mark.parametrize("window", [None, 100])
    def test_plain_matches_pallas_interpret(self, window):
        """The kernel's plain version against the Pallas forward kernel
        in interpret mode (S=256, D=64, GQA 4:2)."""
        rng = np.random.default_rng(3)
        q, k, v = _qkv(rng, 1, 256, 4, 2, 64)
        jo, jl = jflash.flash_attention_with_lse(
            *map(jnp.asarray, (q, k, v)), causal=True, window=window,
            block_q=128, block_k=128, interpret=True)
        to, tl = tflash.flash_attention_with_lse(
            *map(torch.from_numpy, (q, k, v)), causal=True, window=window)
        np.testing.assert_allclose(to.numpy(), _np(jo), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=2e-5, rtol=2e-5)

    def test_ragged_length_and_segments(self):
        """A length no block divides, with packed segments: the JAX
        wrapper falls back to its einsum reference here; the port's
        version (what the kernel computes) must agree."""
        rng = np.random.default_rng(4)
        q, k, v = _qkv(rng, 2, 200, 4, 1, 64)
        seg = np.sort(rng.integers(0, 3, (2, 200)), axis=1).astype(np.int32)
        jo, jl = jflash.flash_attention_with_lse(
            *map(jnp.asarray, (q, k, v)), causal=True,
            segment_ids=jnp.asarray(seg))
        to, tl = tflash.flash_attention_with_lse(
            *map(torch.from_numpy, (q, k, v)), causal=True,
            segment_ids=torch.from_numpy(seg))
        np.testing.assert_allclose(to.numpy(), _np(jo), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=2e-5, rtol=2e-5)

    def test_argument_rules(self):
        q = torch.zeros(1, 8, 2, 64)
        k = torch.zeros(1, 16, 2, 64)
        with pytest.raises(ValueError, match="Sq == Sk"):
            tflash.flash_attention_with_lse(q, k, k, causal=True)
        with pytest.raises(ValueError, match="bwd_impl"):
            tflash.flash_attention_with_lse(q, q, q, bwd_impl="nope")
        with pytest.raises(ValueError, match="window"):
            tflash.flash_attention_with_lse(q, q, q, causal=False, window=4)
        # Non-causal Sq != Sk is allowed and matches the einsum path.
        o, _ = tflash.flash_attention_with_lse(q, k, k, causal=False)
        assert o.shape == q.shape

    def test_pick_block(self):
        assert tflash.pick_block(1000, 512) == jflash.pick_block(1000, 512)
        assert tflash.pick_block(2048, 512) == 512


class TestPagedDecode:
    def test_plain_matches_pallas_interpret(self):
        """Ragged positions, holes in the tables, GQA and an idle row,
        against the Pallas decode kernel in interpret mode."""
        rng = np.random.default_rng(5)
        B, H, KV, Hd, page, P = 4, 4, 2, 16, 4, 9
        q = rng.standard_normal((B, H, Hd)).astype(np.float32)
        kp = rng.standard_normal((P, page, KV, Hd)).astype(np.float32)
        vp = rng.standard_normal((P, page, KV, Hd)).astype(np.float32)
        tables = np.array([[5, 2, -1, -1], [1, -1, -1, -1],
                           [3, -1, 7, 8], [-1, -1, -1, -1]], np.int32)
        pos = np.array([6, 2, 13, -1], np.int32)
        want = jpaged.paged_decode_attention(
            *map(jnp.asarray, (q, kp, vp, tables, pos)), interpret=True)
        got = tpaged.paged_decode_attention(
            *map(torch.from_numpy, (q, kp, vp, tables, pos)))
        np.testing.assert_allclose(got[:3].numpy(), _np(want)[:3],
                                   atol=1e-5, rtol=1e-5)
        assert (got[3].numpy() == 0).all()  # idle row → zeros


class TestKernelModules:
    def test_import_without_toolchain(self):
        """The kernel modules import, and their CPU paths run, with no
        nvcc and no triton: nothing builds or launches off the card."""
        for name in ("flash", "paged_attention", "_build"):
            importlib.import_module(f"polyaxon_tpu_torch.ops.{name}")
        from polyaxon_tpu_torch.ops import _build

        before = (tflash.launches, tpaged.launches)
        q = torch.zeros(1, 4, 2, 64)
        tflash.flash_attention(q, q, q)
        tpaged.paged_decode_attention(
            torch.zeros(1, 2, 64), torch.zeros(2, 4, 1, 64),
            torch.zeros(2, 4, 1, 64), torch.tensor([[1]]), torch.tensor([0]))
        assert (tflash.launches, tpaged.launches) == before
        assert _build._libs == {}
        assert "triton" not in sys.modules

    def test_kernel_sources_name_what_they_replace(self):
        from polyaxon_tpu_torch.ops import _build

        for name, pallas in (("flash_fwd", "_fwd_kernel"),
                             ("paged_decode", "_decode_kernel")):
            with open(f"{_build.CSRC}/{name}.cu") as fh:
                text = fh.read()
            assert pallas in text and "bound" in text

    def test_forward_kernel_is_built_from_wgmma_and_tma(self):
        """The forward compiles from its source and the Hopper header
        alone: both products on ``wgmma``, K/V through TMA and
        ``mbarrier``s, no ``mma.sync``."""
        from polyaxon_tpu_torch.ops import _build

        assert _build._sources("flash_fwd") == ["flash_fwd.cu",
                                                "sm90_bf16.cuh"]
        text = ""
        for rel in _build._sources("flash_fwd"):
            with open(f"{_build.CSRC}/{rel}") as fh:
                text += fh.read()
        for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                       "mbarrier.try_wait", "setmaxnreg",
                       "cudaGetDriverEntryPoint"):
            assert needle in text
        assert "mma.sync" not in text

    def test_backward_kernels_are_built_from_wgmma_and_tma(self):
        """The backward pair compiles from its source and the Hopper
        header alone: every product on ``wgmma``, tiles through TMA and an
        ``mbarrier`` ring, no ``mma.sync``; the C entry points the wrapper
        binds are all there."""
        from polyaxon_tpu_torch.ops import _build

        assert _build._sources("flash_bwd") == ["flash_bwd.cu",
                                                "sm90_bf16.cuh"]
        with open(f"{_build.CSRC}/flash_bwd.cu") as fh:
            source = fh.read()
        with open(f"{_build.CSRC}/sm90_bf16.cuh") as fh:
            text = source + fh.read()
        for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                       "mbarrier.try_wait", "setmaxnreg",
                       "cuTensorMapEncodeTiled"):
            assert needle in text
        assert "mma.sync" not in text
        for entry in ("flash_bwd_dkdv_bf16", "flash_bwd_dkdv_split_bf16",
                      "flash_bwd_dkdv_split", "flash_bwd_dq_bf16"):
            assert f"int {entry}(" in source
        assert "mma_bf16.cuh" not in os.listdir(_build.CSRC)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_import_boundary():
    """The port and chip_smoke.py import no jax and nothing of the JAX
    package (``polyaxon_tpu`` is a prefix of ``polyaxon_tpu_torch``, so
    the check is on the first dotted component), and none of pydantic,
    PyYAML or psutil, which the JAX package's tracking and control plane
    need."""
    import glob
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = glob.glob(os.path.join(root, "polyaxon_tpu_torch", "**",
                                   "*.py"), recursive=True)
    files.append(os.path.join(root, "chip_smoke.py"))
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "optax", "orbax", "flax",
                       "polyaxon_tpu", "pydantic", "yaml", "psutil"):
                bad.append((os.path.relpath(path, root), mod))
    assert bad == []
