"""The paged decode kernel's split-and-merge algorithm, on the CPU.

The kernel (``polyaxon_tpu_torch/ops/csrc/paged_decode.cu``) runs only on
the card. What it computes beyond the plain version is where each block's
pages come from and how the blocks' partials merge. ``split_render``
below is a plain PyTorch rendering of exactly that, used by these tests
only: each row's live tokens cut into tiles of ``TILE_TOKENS``,
split ``s`` of ``n`` taking tiles ``[s * ntiles // n, (s + 1) * ntiles //
n)``, each split's (O, m, l) over its visible tokens, and the lse-weighted
merge in split order. It is held against ``paged_decode_plain`` and JAX's
Pallas ``paged_decode_attention`` (interpret mode) on numpy-seeded f32
inputs, at atol/rtol 1e-5 (the same f32 arithmetic in another order).
The split-count rule ``decode_splits`` is a pure function; its
properties are tested directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops import paged_attention as jpaged
from polyaxon_tpu_torch.ops import paged_attention as tpaged

torch.set_num_threads(1)

H100_SMS = 132


def split_render(q, k_pages, v_pages, tables, pos, nsplit):
    """The kernel's partition and merge in f32. Returns [B, H, Hd]."""
    B, H, Hd = q.shape
    _, page, KV, _ = k_pages.shape
    maxp = tables.shape[1]
    rep, tile = H // KV, tpaged.TILE_TOKENS
    out = torch.zeros(B, H, Hd)
    for b in range(B):
        last = min(int(pos[b]), maxp * page - 1)
        ntiles = last // tile + 1 if last >= 0 else 0
        parts = []
        for s in range(nsplit):
            t0, t1 = s * ntiles // nsplit, (s + 1) * ntiles // nsplit
            toks = torch.arange(t0 * tile, t1 * tile)
            pid = tables[b, (toks // page).clamp(max=maxp - 1)].long()
            ok = (toks <= last) & (pid >= 0)
            keys = k_pages[pid.clamp(min=0), toks % page].repeat_interleave(
                rep, dim=1)  # [n, H, Hd]
            vals = v_pages[pid.clamp(min=0), toks % page].repeat_interleave(
                rep, dim=1)
            sc = torch.einsum("hd,nhd->hn", q[b], keys) * Hd ** -0.5
            sc = torch.where(ok[None, :], sc, float("-inf"))
            m = sc.amax(dim=-1).clamp(min=tpaged.NEG_INF) if len(toks) \
                else torch.full((H,), tpaged.NEG_INF)
            p = torch.exp(sc - m[:, None])
            parts.append((torch.einsum("hn,nhd->hd", p, vals), m,
                          p.sum(dim=-1)))
        big_m = torch.stack([m for _, m, _ in parts]).amax(dim=0)
        acc, total = torch.zeros(H, Hd), torch.zeros(H)
        for o, m, l in parts:  # split order
            w = torch.exp(m - big_m)
            acc = acc + w[:, None] * o
            total = total + w * l
        safe = torch.where(total > 0, total, torch.ones_like(total))
        out[b] = torch.where(total[:, None] > 0, acc / safe[:, None], 0.0)
    return out


def _inputs(seed, B, H, KV, Hd, page, maxp):
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.standard_normal((B, H, Hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, KV, Hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, Hd)).astype(np.float32)
    tables = (1 + rng.permutation(P - 1)).astype(np.int32).reshape(B, maxp)
    return q, kp, vp, tables


def _check(q, kp, vp, tables, pos, nsplit):
    """The rendering against the plain version and the Pallas kernel;
    returns the rendering's output."""
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, pos)]
    got = split_render(*t, nsplit)
    assert torch.isfinite(got).all()
    plain = tpaged.paged_decode_plain(*t)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)
    want = np.asarray(jpaged.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, tables, pos)), interpret=True),
        np.float32)
    live = pos >= 0  # the Pallas kernel's idle rows are not defined as 0
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=1e-5,
                               rtol=1e-5)
    return got


def _tiles(pos, page, maxp):
    last = min(pos, maxp * page - 1)
    return last // tpaged.TILE_TOKENS + 1 if last >= 0 else 0


class TestSplitRule:
    def test_one_split_when_the_grid_fills_the_card(self):
        # llama3_1b decode at 64 rows: 512 blocks for 132 SMs.
        assert tpaged.decode_splits(64, 32, 8, 16, 128, H100_SMS) == 1
        for B, H, KV in ((66, 8, 8), (528, 8, 1), (33, 32, 16)):
            assert B * KV >= tpaged.BLOCKS_PER_SM * H100_SMS
            assert tpaged.decode_splits(B, H, KV, 16, 512,
                                        H100_SMS) == 1

    def test_splits_fill_the_card(self):
        # llama3_8b at 8 rows: 64 (row, kv head) blocks -> 8 splits, 512
        # blocks, four per SM.
        assert tpaged.decode_splits(8, 32, 8, 16, 128, H100_SMS) == 8
        assert tpaged.decode_splits(8, 32, 8, 16, 512, H100_SMS) == 8
        # gemma_2b's MQA at 8 rows: 8 blocks; 66 would fill the card, 32
        # leave each split of a full 512-page row 8 tiles.
        assert tpaged.decode_splits(8, 8, 1, 16, 512, H100_SMS) == 32
        # A group of more than 16 q heads takes a block per 16.
        assert tpaged.decode_splits(4, 48, 1, 16, 1024, H100_SMS) == 44
        # A narrow table: too few tiles to split.
        assert tpaged.decode_splits(1, 8, 1, 16, 8, H100_SMS) == 1

    @pytest.mark.parametrize("page", [4, 16, 32])
    def test_bounds(self, page):
        tile = tpaged.TILE_TOKENS
        for B in (1, 2, 7, 64, 300):
            for H, KV in ((32, 8), (8, 1), (12, 4), (24, 2), (48, 1)):
                for maxp in (1, 2, 3, 8, 128, 512):
                    for sms in (1, 8, 132):
                        n = tpaged.decode_splits(B, H, KV, page, maxp, sms)
                        assert 1 <= n <= tpaged.MAX_SPLITS
                        assert n <= maxp
                        assert n == 1 or n * tpaged.MIN_SPLIT_TILES \
                            <= -(-(maxp * page) // tile)
                        blocks = B * KV * -(-(H // KV) // 16)
                        if blocks >= tpaged.BLOCKS_PER_SM * sms:
                            assert n == 1
                        else:
                            assert blocks * n <= max(
                                blocks, tpaged.BLOCKS_PER_SM * sms)


class TestSplitRender:
    def test_short_row_leaves_splits_empty(self):
        """A row of 2 tiles over 8 splits: six splits are empty and
        write m = -1e30, l = 0."""
        q, kp, vp, tables = _inputs(0, 3, 8, 2, 64, 16, 16)
        short = tpaged.TILE_TOKENS + 6
        pos = np.array([short, 255, 5], np.int32)
        assert _tiles(short, 16, 16) == 2 and _tiles(5, 16, 16) == 1
        _check(q, kp, vp, tables, pos, 8)

    @pytest.mark.parametrize("pos0", [63, 64, 127, 128])
    def test_pos_on_a_page_and_tile_boundary(self, pos0):
        q, kp, vp, tables = _inputs(1, 2, 8, 2, 128, 16, 12)
        pos = np.array([pos0, 15], np.int32)
        for nsplit in (1, 2, 3):
            _check(q, kp, vp, tables, pos, nsplit)

    def test_hole_as_a_splits_first_page(self):
        Hd, page, maxp, nsplit = 256, 4, 32, 3
        q, kp, vp, tables = _inputs(2, 2, 8, 1, Hd, page, maxp)
        pos = np.array([maxp * page - 1, 50], np.int32)
        ntiles = _tiles(int(pos[0]), page, maxp)
        # split 1's first page
        first = (1 * ntiles // nsplit) * tpaged.TILE_TOKENS // page
        assert first > 0
        tables[0, first] = -1
        tables[0, first + 1] = -1
        _check(q, kp, vp, tables, pos, nsplit)

    def test_all_visible_pages_holes_and_idle_row(self):
        q, kp, vp, tables = _inputs(3, 3, 4, 2, 64, 4, 8)
        tables[0, :] = -1              # every page a hole: zeros
        tables[1, 3:] = -1             # holes past the row's end
        pos = np.array([20, 11, -1], np.int32)
        got = _check(q, kp, vp, tables, pos, 2)
        assert (got[0] == 0).all() and (got[2] == 0).all()

    @pytest.mark.parametrize("H,KV", [(4, 4), (6, 2), (8, 2), (8, 1),
                                      (12, 1)])
    def test_gqa_groups(self, H, KV):
        """rep 1, 3, 4, 8 and 12, several splits, ragged rows."""
        q, kp, vp, tables = _inputs(4, 3, H, KV, 64, 16, 12)
        tables[1, 2] = -1
        pos = np.array([191, 100, 30], np.int32)
        for nsplit in (1, 3):
            _check(q, kp, vp, tables, pos, nsplit)

    @pytest.mark.parametrize("Hd,page", [(64, 16), (128, 32), (256, 16)])
    def test_head_dims(self, Hd, page):
        maxp = 512 // page
        q, kp, vp, tables = _inputs(5, 2, 8, 2, Hd, page, maxp)
        tables[0, 1] = -1
        pos = np.array([511, 77], np.int32)
        n = tpaged.decode_splits(2, 8, 2, page, maxp, H100_SMS)
        assert n > 1
        for nsplit in (1, n):
            _check(q, kp, vp, tables, pos, nsplit)
