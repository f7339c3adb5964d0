"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a GPU every test skips (the decision is
made inside the fixture, never at import). This file imports no JAX, so
on a machine without it run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are bf16 ones, about two ulps (atol 1e-2 + rtol 1e-2): outputs
round to bf16 (2^-8 relative) and the kernels round P to bf16 for the
tensor-core product; lse is f32 (2e-3). Gradients are sums of up to
S * n_rep bf16-rounded products whose size depends on the shape, so the
backward's absolute tolerance is taken relative to the largest reference
value: |kernel - plain| <= 1e-2 * max|plain| + 2e-2 * |plain|.
"""

import ctypes
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch.ops import flash, paged_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


@pytest.mark.parametrize("S,H,KV,D,window,segments,causal", [
    (1, 4, 4, 128, None, False, True),
    (77, 8, 2, 64, None, False, True),
    (300, 8, 8, 128, 50, False, True),
    (130, 4, 1, 128, None, True, True),
    (200, 4, 2, 64, None, False, False),
    (150, 8, 1, 256, None, False, True),   # gemma_2b's head_dim
    (90, 8, 1, 256, 40, True, True),
    # The forward's tile edges: 128 q rows per block (two warpgroups of
    # 64), 128 keys per tile at head_dim 64/128 and 64 at 256.
    (127, 4, 2, 64, None, False, True),
    (129, 8, 8, 128, None, True, True),
    (200, 8, 1, 256, None, False, True),   # MQA 8:1, ragged key tile
    (1, 8, 1, 256, None, False, True),
    (333, 8, 2, 128, 70, True, True),      # window with segments
    (700, 8, 1, 256, 300, True, True),     # gemma: window, segments
    (257, 4, 4, 64, None, False, False),   # non-causal, ragged
])
def test_flash_matches_plain(gen, S, H, KV, D, window, segments, causal):
    B = 2
    q, k, v = _rand(gen, B, S, H, D), _rand(gen, B, S, KV, D), \
        _rand(gen, B, S, KV, D)
    seg = None
    if segments:
        seg = torch.sort(torch.randint(0, 3, (B, S), generator=gen,
                                       device="cuda"), dim=1).values
    before = flash.launches
    o, lse = flash.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window, segment_ids=seg)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    po, plse = flash.flash_fwd_plain(q, k, v, causal=causal,
                                     scale=D ** -0.5, window=window,
                                     segment_ids=seg)
    torch.testing.assert_close(o.float(), po.float(), atol=1e-2, rtol=1e-2)
    assert (lse - plse).abs().max().item() < 2e-3


def _bwd_close(got, want):
    want = want.float()
    torch.testing.assert_close(got.float(), want,
                               atol=1e-2 * want.abs().max().item(),
                               rtol=2e-2)


@pytest.mark.parametrize("B,S,H,KV,D,window,segments,causal", [
    (2, 1, 4, 4, 64, None, False, True),
    (2, 77, 8, 2, 128, None, False, True),
    (2, 300, 8, 8, 128, 50, False, True),
    (2, 300, 8, 1, 64, None, True, True),      # GQA 8
    (2, 130, 8, 2, 128, None, True, True),     # GQA 4, ragged, segments
    (2, 200, 4, 2, 64, None, False, False),    # non-causal
    (1, 4096, 32, 8, 64, None, True, True),    # the llama3_1b slice
    (1, 4096, 32, 8, 128, 1000, False, True),  # llama3_8b, a window
    (2, 300, 8, 1, 256, None, False, True),    # head_dim 256, MQA 8:1
    (2, 333, 8, 1, 256, 90, True, True),       # segments and a window
    (1, 4096, 8, 1, 256, None, True, True),    # the gemma_2b slice
])
def test_flash_bwd_matches_plain(gen, B, S, H, KV, D, window, segments,
                                 causal):
    q, k, v = _rand(gen, B, S, H, D), _rand(gen, B, S, KV, D), \
        _rand(gen, B, S, KV, D)
    seg = None
    if segments:
        seg = torch.sort(torch.randint(0, 5, (B, S), generator=gen,
                                       device="cuda"), dim=1).values
    o, lse = flash.flash_fwd_cuda(q, k, v, causal=causal, scale=D ** -0.5,
                                  window=window, segment_ids=seg)
    do = _rand(gen, B, S, H, D)
    dlse = 0.1 * torch.randn(B, H, S, generator=gen, device="cuda")
    before = (flash.bwd_dkdv_launches, flash.bwd_dq_launches)
    got = flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, dlse,
                               causal=causal, scale=D ** -0.5, window=window)
    torch.cuda.synchronize()
    assert (flash.bwd_dkdv_launches, flash.bwd_dq_launches) == (
        before[0] + 1, before[1] + 1)
    want = flash.flash_bwd_plain(q, k, v, seg, o, lse, do, dlse,
                                 causal=causal, scale=D ** -0.5,
                                 window=window)
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        _bwd_close(g_, w_)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_fwd_cross_lengths(gen, D):
    """Non-causal attention with Sq != Sk, both ragged, at B=3: the
    forward's q tiles follow Sq and its key tiles Sk."""
    for Sq, Sk in ((100, 300), (300, 77), (1, 129)):
        q = _rand(gen, 3, Sq, 8, D)
        k, v = _rand(gen, 3, Sk, 2, D), _rand(gen, 3, Sk, 2, D)
        o, lse = flash.flash_attention_with_lse(q, k, v, causal=False)
        torch.cuda.synchronize()
        po, plse = flash.flash_fwd_plain(q, k, v, causal=False,
                                         scale=D ** -0.5)
        torch.testing.assert_close(o.float(), po.float(), atol=1e-2,
                                   rtol=1e-2)
        assert (lse - plse).abs().max().item() < 2e-3


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_bwd_cross_lengths(gen, D):
    """Non-causal attention with Sq != Sk (a ragged 100 queries over 300
    keys, GQA 2:1): the dK/dV grid follows Sk, the dQ grid Sq."""
    B, Sq, Sk, H, KV = 2, 100, 300, 4, 2
    q, do = _rand(gen, B, Sq, H, D), _rand(gen, B, Sq, H, D)
    k, v = _rand(gen, B, Sk, KV, D), _rand(gen, B, Sk, KV, D)
    o, lse = flash.flash_fwd_cuda(q, k, v, causal=False, scale=D ** -0.5)
    dlse = torch.randn(B, H, Sq, generator=gen, device="cuda")
    kw = dict(causal=False, scale=D ** -0.5)
    got = flash.flash_bwd_cuda(q, k, v, None, o, lse, do, dlse, **kw)
    want = flash.flash_bwd_plain(q, k, v, None, o, lse, do, dlse, **kw)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        _bwd_close(g_, w_)


def _bwd_case(gen, B, S, H, KV, D, segments):
    q, k, v = _rand(gen, B, S, H, D), _rand(gen, B, S, KV, D), \
        _rand(gen, B, S, KV, D)
    seg = None
    if segments:
        seg = torch.sort(torch.randint(0, 6, (B, S), generator=gen,
                                       device="cuda"), dim=1).values
    o, lse = flash.flash_fwd_cuda(q, k, v, causal=True, scale=D ** -0.5,
                                  segment_ids=seg)
    do = _rand(gen, B, S, H, D)
    dlse = 0.1 * torch.randn(B, H, S, generator=gen, device="cuda")
    return q, k, v, seg, o, lse, do, dlse


@pytest.mark.parametrize("B,S,H,KV,D,split", [
    # One block per (key tile, kv head, batch row) fills the card: each
    # block loops over its whole GQA group and writes bf16 dK/dV.
    (4, 2048, 32, 8, 64, False),
    (2, 2176, 32, 8, 128, False),
    # Too few such blocks (MQA, one batch row): the group's q heads are
    # split over blocks into f32 partials, summed by a second kernel.
    (1, 1000, 8, 1, 256, True),
    (1, 1536, 32, 8, 64, True),
])
def test_flash_bwd_grid_paths(gen, B, S, H, KV, D, split):
    """Both dK/dV grids against ``flash_bwd_plain``, with packed
    segments and an lse cotangent."""
    _, _, split_fn = flash._bwd_entries()
    n_split = split_fn(B, S, H, KV, D)
    assert (n_split > 1) == split and (H // KV) % n_split == 0
    args = _bwd_case(gen, B, S, H, KV, D, segments=True)
    kw = dict(causal=True, scale=D ** -0.5)
    got = flash.flash_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = flash.flash_bwd_plain(*args, **kw)
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        _bwd_close(g_, w_)


@pytest.mark.parametrize("B,S,H,KV,D", [
    (2, 1024, 32, 8, 64),    # the in-block group loop
    (1, 1024, 8, 1, 256),    # the head-split grid and its partial sum
])
def test_flash_bwd_is_deterministic(gen, B, S, H, KV, D):
    """No atomics: two calls on the same inputs give bitwise-equal dq,
    dk and dv."""
    args = _bwd_case(gen, B, S, H, KV, D, segments=False)
    kw = dict(causal=True, scale=D ** -0.5)
    first = [t.clone() for t in flash.flash_bwd_cuda(*args, **kw)]
    second = flash.flash_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bwd_fully_masked_rows_give_zero(gen):
    """Query rows whose segment no key shares (lse = -1e30, o = 0): the
    mask after the exp gives them zero dQ and no share of dK/dV."""
    B, S, H, KV, D = 2, 200, 4, 2, 64
    q, k, v = _rand(gen, B, S, H, D), _rand(gen, B, S, KV, D), \
        _rand(gen, B, S, KV, D)
    kseg = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    qseg = kseg.clone()
    qseg[:, 70:90] = 7
    o, lse = flash.flash_fwd_cuda(q, k, v, causal=True, scale=D ** -0.5)
    o[:, 70:90] = 0
    lse[:, :, 70:90] = -1e30
    do = _rand(gen, B, S, H, D)
    dlse = torch.randn(B, H, S, generator=gen, device="cuda")
    kw = dict(causal=True, scale=D ** -0.5, _kv_segment_ids=kseg)
    got = flash.flash_bwd_cuda(q, k, v, qseg, o, lse, do, dlse, **kw)
    want = flash.flash_bwd_plain(q, k, v, qseg, o, lse, do, dlse, **kw)
    torch.cuda.synchronize()
    assert got[0][:, 70:90].abs().max().item() == 0.0
    for g_, w_ in zip(got, want):
        _bwd_close(g_, w_)


@pytest.mark.parametrize("bwd_impl", [None, "xla"])
def test_flash_autograd_routes_backward(gen, bwd_impl):
    """Through ``flash_attention_with_lse``: the default backward launches
    both kernels once; ``bwd_impl="xla"`` launches none and runs the
    plain backward. Both give the same gradients."""
    B, S, H, KV, D = 2, 256, 8, 2, 64
    leaves = [_rand(gen, B, S, H, D), _rand(gen, B, S, KV, D),
              _rand(gen, B, S, KV, D)]
    for t in leaves:
        t.requires_grad_(True)
    w = torch.randn(B, H, S, generator=gen, device="cuda")
    before = (flash.bwd_dkdv_launches, flash.bwd_dq_launches)
    o, lse = flash.flash_attention_with_lse(*leaves, causal=True,
                                            bwd_impl=bwd_impl)
    (o.float().square().sum() + (lse * w).sum()).backward()
    torch.cuda.synchronize()
    moved = (flash.bwd_dkdv_launches - before[0],
             flash.bwd_dq_launches - before[1])
    assert moved == ((1, 1) if bwd_impl is None else (0, 0))
    q, k, v = (t.detach() for t in leaves)
    o, lse = flash.flash_fwd_cuda(q, k, v, causal=True, scale=D ** -0.5)
    want = flash.flash_bwd_plain(q, k, v, None, o, lse, 2 * o.float(), w,
                                 causal=True, scale=D ** -0.5)
    for t, w_ in zip(leaves, want):
        _bwd_close(t.grad, w_)


def test_flash_bwd_refuses_what_it_cannot_take(gen):
    for d in (96,):
        q = _rand(gen, 1, 8, 2, d)
        lse = torch.zeros(1, 2, 8, device="cuda")
        before = (flash.bwd_dkdv_launches, flash.bwd_dq_launches)
        with pytest.raises(ValueError, match="head_dim"):
            flash.flash_bwd_cuda(q, q, q, None, q, lse, q, None,
                                 causal=True, scale=1.0)
        assert (flash.bwd_dkdv_launches, flash.bwd_dq_launches) == before


def test_flash_refuses_what_it_cannot_take(gen):
    q = torch.randn(1, 8, 2, 128, generator=gen, device="cuda")  # f32
    with pytest.raises(TypeError, match="bf16"):
        flash.flash_attention_with_lse(q, q, q)
    q = _rand(gen, 1, 8, 2, 96)  # a head_dim the kernel has no variant for
    before = flash.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention_with_lse(q, q, q)
    assert flash.launches == before


def _paged_inputs(gen, B, H, KV, Hd, page, maxp):
    """Tables with a hole inside row 0, row 2 cut short, row 3 idle."""
    P = B * maxp + 1
    tables = torch.arange(1, P, device="cuda", dtype=torch.int32).reshape(
        B, maxp)
    tables[0, 1] = -1
    tables[2, 3:] = -1
    pos = torch.tensor([maxp * page - 1, 3, 2 * page + 1, -1],
                       device="cuda", dtype=torch.int32)
    q = _rand(gen, B, H, Hd)
    kp, vp = _rand(gen, P, page, KV, Hd), _rand(gen, P, page, KV, Hd)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("H,KV,Hd,page", [
    (32, 8, 128, 16), (8, 1, 256, 16), (4, 2, 64, 4), (8, 8, 128, 32),
    (12, 4, 64, 16),    # llama3_draft_200m: a group of 3
    (24, 2, 128, 16),   # a group of 12
    (48, 1, 64, 16),    # a group of 48: three blocks per kv head
])
@pytest.mark.parametrize("splits", [1, 3, None])
def test_paged_decode_matches_plain(gen, H, KV, Hd, page, splits):
    """One split and several forced (row 0 spans many tiles, rows 1-3
    leave splits empty), and the rule's own count."""
    q, kp, vp, tables, pos = _paged_inputs(gen, 4, H, KV, Hd, page, 40)
    before = paged_attention.launches
    out = paged_attention.paged_decode_cuda(q, kp, vp, tables, pos,
                                            splits=splits)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention.paged_decode_plain(q, kp, vp, tables, pos)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    assert out[3].abs().max().item() == 0.0


def test_paged_decode_tile_matches_the_library(gen):
    lib, _ = paged_attention._entry()
    lib.paged_decode_tile_tokens.restype = ctypes.c_int
    lib.paged_decode_tile_tokens.argtypes = [ctypes.c_int]
    for hd in paged_attention.KERNEL_HEAD_DIMS:
        assert lib.paged_decode_tile_tokens(hd) == \
            paged_attention.TILE_TOKENS


@pytest.mark.parametrize("splits", [1, 5, None])
def test_paged_decode_is_deterministic(gen, splits):
    """Two calls give bitwise-equal outputs, whichever block merges."""
    q, kp, vp, tables, pos = _paged_inputs(gen, 4, 8, 1, 256, 16, 64)
    a = paged_attention.paged_decode_cuda(q, kp, vp, tables, pos,
                                          splits=splits)
    b = paged_attention.paged_decode_cuda(q, kp, vp, tables, pos,
                                          splits=splits)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_paged_decode_graph_replay_equals_eager(gen):
    """The wrapper captures in a CUDA graph (no host sync, no
    cudaMalloc), and a replay on new inputs in the same buffers equals
    the eager call."""
    q, kp, vp, tables, pos = _paged_inputs(gen, 4, 32, 8, 128, 16, 64)
    assert paged_attention.decode_splits(
        4, 32, 8, 16, 64,
        torch.cuda.get_device_properties(0).multi_processor_count) > 1
    paged_attention.paged_decode_attention(q, kp, vp, tables, pos)  # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention.paged_decode_attention(q, kp, vp, tables, pos)
    q.copy_(_rand(gen, *q.shape))
    pos[1] = 400
    graph.replay()
    torch.cuda.synchronize()
    want = paged_attention.paged_decode_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_paged_decode_two_streams_do_not_race(gen):
    """Multi-split launches on two streams at once: each stream has its
    own merge counters, so every output equals the plain version and
    its stream's first output, bitwise."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [_paged_inputs(gen, 4, 32, 8, 128, 16, 64),
             _paged_inputs(gen, 4, 8, 1, 256, 16, 64)]
    for q, kp, vp, tables, _ in cases:
        assert paged_attention.decode_splits(
            q.shape[0], q.shape[1], kp.shape[2], kp.shape[1],
            tables.shape[1], sms) > 1
    refs = [paged_attention.paged_decode_plain(*c) for c in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(50):
        for i, (s, c) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                outs[i].append(paged_attention.paged_decode_attention(*c))
    torch.cuda.synchronize()
    for ref, got in zip(refs, outs):
        torch.testing.assert_close(got[0].float(), ref.float(), atol=1e-2,
                                   rtol=1e-2)
        assert all(torch.equal(o, got[0]) for o in got)


def test_checkpoint_round_trip_on_the_card(gen, tmp_path):
    """A state on the card (f32 and bf16 tensors, scalars) saved
    asynchronously through page-locked host buffers, then restored from
    memory, from the spill and from the store into zeroed tensors: all
    bitwise equal, the snapshot taken before ``save`` returned."""
    from polyaxon_tpu_torch.runtime import tiers
    from polyaxon_tpu_torch.runtime.checkpoint import (
        CheckpointSpec, TieredCheckpointManager)

    def make(fill=None):
        w = torch.randn(1000, 257, generator=gen, device="cuda")
        h = _rand(gen, 3, 70001)
        if fill is not None:
            w.fill_(fill)
            h.fill_(fill)
        return {"step": 0 if fill is not None else 5,
                "params": {"w": w, "h": h},
                "opt_state": {"count": 0 if fill is not None else 5,
                              "mu": [w.clone()]}}

    st = make()
    want = {k: v.clone() for k, v in st["params"].items()}
    mgr = TieredCheckpointManager(
        str(tmp_path / "ck"), CheckpointSpec(interval_steps=1))
    mgr.prepare(st)
    mgr.save(5, st)
    st["params"]["w"].add_(1.0)  # after save returned: not in the step
    mgr.wait()
    for drop in ((), ("memory",), ("memory", "spill")):
        if "memory" in drop:
            tiers.TIER0.drop(mgr.directory)
        if "spill" in drop:
            mgr._spill.drop_all()
        got = mgr.restore(make(fill=0.0))
        assert mgr.last_restore_tier == str(len(drop))
        assert got["step"] == 5 and got["opt_state"]["count"] == 5
        for k, v in want.items():
            assert torch.equal(got["params"][k], v), (k, drop)
        assert torch.equal(got["opt_state"]["mu"][0], want["w"])
    mgr.close()
    tiers.TIER0.clear()


def test_paged_decode_refuses_what_it_cannot_take(gen):
    q, kp = _rand(gen, 2, 4, 96), _rand(gen, 3, 16, 2, 96)
    tables = torch.ones(2, 1, device="cuda", dtype=torch.int32)
    pos = torch.zeros(2, device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention.paged_decode_attention(q, kp, kp, tables, pos)


def test_training_config_refused_at_construction(gen):
    """A head_dim no kernel takes (llama_200m widened to head_dim 96):
    a flash training job is refused before any weight is allocated.
    gemma_2b's head_dim 256 passes the same check."""
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    job = {"runtime": {"model": "llama_200m", "attention_impl": "flash",
                       "dim": 768, "n_heads": 8, "n_kv_heads": 4}}
    with pytest.raises(ValueError, match="head_dim"):
        run_torchjob(job)
    gemma = dataclasses.replace(llama.CONFIGS["gemma_2b"],
                                attention_impl="flash")
    llama.check_kernel_shapes(gemma, "cuda", training=True)


def test_launcher_trains_llama_200m(gen, tmp_path):
    """``python -m polyaxon_tpu_torch.runtime.launch`` trains llama_200m
    (head_dim 64) for 3 packed steps through the flash kernels, logs one
    JSON line per emission and exits 0."""
    spec = {"kind": "jaxjob", "checkpointing": {"enabled": False},
            "runtime": {"model": "llama_200m", "dataset": "lm_packed_synthetic",
                        "steps": 3, "seq_len": 1024, "global_batch_size": 4,
                        "grad_accum_steps": 2, "log_every": 1,
                        "attention_impl": "flash", "remat": "dots"}}
    env = dict(os.environ, POLYAXON_JAXJOB_SPEC=json.dumps(spec),
               POLYAXON_RUN_ARTIFACTS_PATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "polyaxon_tpu_torch.runtime.launch"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    steps = [x for x in lines if "loss" in x]
    assert [x["step"] for x in steps] == [1, 2]
    assert all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
               and 0 < x["mfu"] < 1 for x in steps)
    assert lines[-1]["outputs"]["steps"] == 3


def test_cli_serves_and_stops_on_sigterm(gen):
    """``python -m polyaxon_tpu_torch.serving`` answers a generate call,
    then exits 0 on SIGTERM."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "polyaxon_tpu_torch.serving", "--model",
         "llama_200m", "--host", "127.0.0.1", "--port", str(port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 300
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                with urllib.request.urlopen(f"{url}/healthz", timeout=5):
                    break
            except OSError:
                assert time.time() < deadline, "the server never answered"
                time.sleep(1)
        body = json.dumps({"tokens": [[1, 2, 3, 4]],
                           "max_new_tokens": 4}).encode()
        req = urllib.request.Request(
            f"{url}/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert len(json.loads(resp.read())["tokens"][0]) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
