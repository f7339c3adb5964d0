"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a GPU every test skips (the decision is
made inside the fixture, never at import). This file imports no JAX, so
on a machine without it run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are bf16 ones, about two ulps (atol 1e-2 + rtol 1e-2): outputs
round to bf16 (2^-8 relative) and the kernels round P to bf16 for the
tensor-core product; lse is f32 (2e-3).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

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


def test_flash_refuses_what_it_cannot_take(gen):
    q = torch.randn(1, 8, 2, 128, generator=gen, device="cuda")  # f32
    with pytest.raises(TypeError, match="bf16"):
        flash.flash_attention_with_lse(q, q, q)
    q = _rand(gen, 1, 8, 2, 96)  # a head_dim the kernel has no variant for
    before = flash.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention_with_lse(q, q, q)
    assert flash.launches == before


@pytest.mark.parametrize("H,KV,Hd,page", [
    (32, 8, 128, 16), (8, 1, 256, 16), (4, 2, 64, 4), (8, 8, 128, 32),
    (12, 4, 64, 16),    # llama3_draft_200m: a group of 3
    (24, 2, 128, 16),   # a group of 12: three blocks per kv head
])
def test_paged_decode_matches_plain(gen, H, KV, Hd, page):
    B, maxp = 4, 8
    P = B * maxp + 1
    tables = torch.arange(1, P, device="cuda", dtype=torch.int32).reshape(
        B, maxp)
    tables[0, 1] = -1
    tables[2, 3:] = -1
    pos = torch.tensor([maxp * page - 1, 3, 2 * page + 1, -1],
                       device="cuda", dtype=torch.int32)
    q = _rand(gen, B, H, Hd)
    kp, vp = _rand(gen, P, page, KV, Hd), _rand(gen, P, page, KV, Hd)
    before = paged_attention.launches
    out = paged_attention.paged_decode_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention.paged_decode_plain(q, kp, vp, tables, pos)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    assert out[3].abs().max().item() == 0.0


def test_paged_decode_refuses_what_it_cannot_take(gen):
    q, kp = _rand(gen, 2, 4, 96), _rand(gen, 3, 16, 2, 96)
    tables = torch.ones(2, 1, device="cuda", dtype=torch.int32)
    pos = torch.zeros(2, device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention.paged_decode_attention(q, kp, kp, tables, pos)


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
