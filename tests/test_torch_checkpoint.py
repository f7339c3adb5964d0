"""The port's checkpointing (``runtime/checkpoint.py``, ``runtime/tiers.py``)
and its resume through ``run_torchjob``, against the JAX package, on the
CPU.

- The tier cases mirror ``tests/test_checkpoint_tiers.py``
  (``TestCrossTierFallback``, ``TestTierMechanics``) on the port's
  manager. Where the reference installs a chaos fault
  (``tier0-loss``, ``checkpoint/corrupt_latest``) the port's is
  installed; the cases that damage one tier's bytes on purpose do so by
  hand, as the reference's do.
- Resume against JAX: ``run_jaxjob`` and ``run_torchjob(device="cpu")``
  on the same spec (llama_tiny, f32, JAX's initial weights through
  ``params_from_numpy``, the same packed batches), each stopped by
  ``should_stop`` and then rerun. Tolerances: the port's resumed losses
  equal its uninterrupted run's exactly (the same f32 arithmetic on the
  CPU); JAX's to 1e-6 relative (XLA may fuse the resumed program
  differently); the two packages agree to 1e-4 on the loss, the
  tolerance of ``_check_trajectory`` in ``tests/test_torch_train.py``
  (Adam's normalised updates carry each step's f32 differences on).
  The restore audit (``restored_from_step``, ``restore_skipped_steps``,
  ``restore_tier``) is compared exactly.
- Restored tensors are byte-identical to the saved ones: their CRC-32s
  equal the manifest's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch.runtime import checkpoint as ck
from polyaxon_tpu_torch.runtime import tiers
from polyaxon_tpu_torch.runtime.checkpoint import (CheckpointSpec,
                                                   TieredCheckpointManager)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_seams():
    yield
    tiers.WEDGE_TIER0_COMMITS = False
    tiers.TIER0.clear()


def state(step: int, n: int = 8):
    """A train state's shapes: scalars, f32 and bf16 tensors, a list."""
    return {"step": step,
            "params": {"w": torch.arange(n, dtype=torch.float32) + step,
                       "h": torch.full((2, 3), float(step),
                                       dtype=torch.bfloat16)},
            "opt_state": {"count": step, "mu": [torch.zeros(4) + step]},
            "state": {}}


def manager(tmp_path, **spec_over):
    spec = dict(enabled=True, async_save=False, max_to_keep=20)
    spec.update(spec_over)
    return TieredCheckpointManager(str(tmp_path / "ckpt"),
                                   CheckpointSpec(**spec))


def snapshot_leaves(st):
    """The flat leaf payload the publisher commits (same keying)."""
    out = {}
    for i, (_, leaf) in enumerate(ck.flatten(st)):
        if isinstance(leaf, torch.Tensor):
            arr = leaf.detach().view(torch.int16).numpy().view(np.uint16) \
                if leaf.dtype == torch.bfloat16 else leaf.detach().numpy()
        else:
            arr = np.asarray(leaf, np.int64)
        out[f"leaf_{i}"] = arr.copy()
    return out


def assert_state(restored, step):
    want = state(step)
    assert restored["step"] == step
    assert restored["opt_state"]["count"] == step
    for (pa, a), (pb, b) in zip(ck.flatten(restored), ck.flatten(want)):
        assert pa == pb
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), pa


def flip_byte(path, offset=-1):
    with open(path, "r+b") as fh:
        fh.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0x40]))


# ===================================================== fallback ordering
class TestCrossTierFallback:
    def test_tier0_hit_wins_without_touching_disk(self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        restored = mgr.restore(state(0))
        assert_state(restored, 4)
        assert mgr.last_restore_tier == tiers.TIER_MEMORY
        assert mgr.last_restore_skipped == []
        mgr.close()

    def test_corrupt_replica_falls_to_local_spill_and_repromotes(
            self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        # Poison the memory replica: wrong leaf count fails validation.
        tiers.TIER0.publish(mgr.directory, 4,
                            {"leaf_0": np.zeros(3, np.float32)})
        restored = mgr.restore(state(0))
        assert_state(restored, 4)
        assert mgr.last_restore_tier == tiers.TIER_LOCAL
        assert mgr.last_restore_skipped == []
        # The spill win re-promoted into memory: next restore is tier-0.
        mgr.restore(state(0))
        assert mgr.last_restore_tier == tiers.TIER_MEMORY
        mgr.close()

    def test_both_cheap_tiers_gone_falls_to_store(self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        tiers.TIER0.drop(mgr.directory)  # a NEW process would start so
        tiers.LocalSpill(mgr.directory).drop_all()  # ...and a new host
        restored = mgr.restore(state(0))
        assert_state(restored, 4)
        assert mgr.last_restore_tier == tiers.TIER_STORE
        assert mgr.last_restore_skipped == []
        mgr.close()

    def test_a_failed_step_leaves_no_copy_in_flight(self, tmp_path,
                                                    monkeypatch):
        """A store step with a corrupt leaf while another of its leaves is
        still being read: the fallback to the older step starts only once
        that read has ended, so no copy of the failed step lands in the
        restored tensors after the older step's."""
        mgr = manager(tmp_path)
        mgr.save(2, state(2), force=True)
        mgr.wait()
        mgr.save(4, state(4), force=True)
        mgr.wait()
        tiers.TIER0.drop(mgr.directory)
        mgr._spill.cull(4)  # step 4 in the store only, step 2 in the spill
        flip_byte(os.path.join(mgr.directory, "4", "leaf_1.npy"))
        slow = os.path.join(mgr.directory, "4", "leaf_2.npy")  # params/h
        read = ck._read_npy_into

        def read_slowly(path, entry, dst, stager):
            if path != slow:
                return read(path, entry, dst, stager)
            late = torch.empty_like(dst)
            out = read(path, entry, late, stager)  # before the step's cull
            time.sleep(0.5)
            dst.copy_(late)  # the copy lands late
            return out

        monkeypatch.setattr(ck, "_read_npy_into", read_slowly)
        restored = mgr.restore(state(0))
        time.sleep(0.7)  # past the slow read
        assert_state(restored, 2)
        assert mgr.last_restore_skipped == [4]
        assert mgr.last_restore_tier == tiers.TIER_LOCAL
        mgr.close()

    def test_all_tiers_corrupt_at_latest_falls_to_older_clean_step(
            self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(2, state(2), force=True)
        mgr.wait()
        mgr.save(4, state(4), force=True)
        mgr.wait()
        # Corrupt step 4 in EVERY tier: replica (bad leaf count), store
        # and spill (a flipped bit in a leaf: the spill's step is hard
        # links to the store's files, so both names see it).
        tiers.TIER0.publish(mgr.directory, 4,
                            {"leaf_0": np.zeros(3, np.float32)})
        leaf = os.path.join(mgr.directory, "4", "leaf_1.npy")
        assert os.path.samefile(leaf, os.path.join(
            mgr._spill.path, "4", "leaf_1.npy"))
        flip_byte(leaf)
        restored = mgr.restore(state(0))
        assert_state(restored, 2)
        assert mgr.last_restore_skipped == [4]
        # Step 2 still lives in the spill (SPILL_KEEP=2): tier-1 won.
        assert mgr.last_restore_tier == tiers.TIER_LOCAL
        # Poisoned tiers were culled: the next restore never retries 4.
        assert mgr.latest_step() == 2
        mgr.close()

    def test_nothing_committed_raises_file_not_found(self, tmp_path):
        mgr = manager(tmp_path)
        with pytest.raises(FileNotFoundError):
            mgr.restore(state(0))
        mgr.close()


# ======================================================== tier mechanics
class TestTierMechanics:
    def test_spill_commit_is_atomic_and_pruned(self, tmp_path):
        spill = tiers.LocalSpill(str(tmp_path / "d"))
        for step in (2, 4, 6):
            assert spill.spill(step, {"leaf_0": np.arange(4.0)})
        # SPILL_KEEP=2: oldest pruned, newest first.
        assert spill.steps() == [6, 4]
        assert not [n for n in os.listdir(spill.path)
                    if n.startswith(".tmp-")]
        # The committed file is an npz that np.load reads.
        with np.load(os.path.join(spill.path, "6.npz")) as data:
            assert np.array_equal(data["leaf_0"], np.arange(4.0))

    def test_spill_load_checks_every_byte(self, tmp_path):
        """The spill's reader reads members straight into their arrays
        and holds each against its zip CRC-32: a flipped bit anywhere in
        a member fails the load."""
        spill = tiers.LocalSpill(str(tmp_path / "d"))
        leaves = {"leaf_0": np.arange(5000.0), "leaf_1": np.int64(7) +
                  np.zeros((), np.int64),
                  "leaf_2": np.arange(12, dtype=np.uint16).reshape(3, 4)}
        spill.spill(3, leaves, manifest={"step": 3})
        arrays, manifest = spill.load(3)
        assert manifest == {"step": 3}
        for k, v in leaves.items():
            assert arrays[k].dtype == v.dtype and np.array_equal(arrays[k], v)
        with np.load(spill._step_path(3)) as data:  # still a plain npz
            assert np.array_equal(data["leaf_0"], leaves["leaf_0"])
        flip_byte(spill._step_path(3), offset=20000)
        with pytest.raises(ValueError, match="CRC"):
            spill.load(3)

    def test_spill_links_the_store_files(self, tmp_path):
        """The manager's spill is hard links to the store step's files:
        nothing is written twice, the spill keeps SPILL_KEEP steps after
        the store has pruned one, and a flipped byte fails its CRC."""
        mgr = manager(tmp_path, max_to_keep=1)
        for step in (2, 4):
            mgr.save(step, state(step), force=True)
            mgr.wait()
        assert mgr._list_steps() == [4] and mgr._spill.steps() == [4, 2]
        for name in os.listdir(os.path.join(mgr.directory, "4")):
            assert os.path.samefile(os.path.join(mgr.directory, "4", name),
                                    os.path.join(mgr._spill.path, "4", name))
        arrays, manifest = mgr._spill.load(2)  # the store pruned step 2
        assert manifest["step"] == 2
        for k, v in snapshot_leaves(state(2)).items():
            assert arrays[k].dtype == v.dtype and np.array_equal(arrays[k], v)
        flip_byte(os.path.join(mgr._spill.path, "2", "leaf_1.npy"))
        with pytest.raises(ValueError, match="CRC"):
            mgr._spill.load(2)
        mgr.close()

    def test_spill_copies_where_it_cannot_link(self, tmp_path,
                                               monkeypatch):
        """Where the store's files cannot be linked (the spill on
        another filesystem), the spill writes its own npz."""
        def no_link(*_):
            raise OSError(18, "Invalid cross-device link")

        monkeypatch.setattr(os, "link", no_link)
        mgr = manager(tmp_path)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        assert mgr._spill.steps() == [4]
        assert sorted(os.listdir(mgr._spill.path)) == ["4.npz"]
        tiers.TIER0.drop(mgr.directory)
        assert_state(mgr.restore(state(0)), 4)
        assert mgr.last_restore_tier == tiers.TIER_LOCAL
        mgr.close()

    def test_wedged_commit_withholds_the_rename(self, tmp_path,
                                                monkeypatch):
        monkeypatch.setattr(tiers, "WEDGE_TIER0_COMMITS", True)
        spill = tiers.LocalSpill(str(tmp_path / "d"))
        assert spill.spill(2, {"leaf_0": np.arange(4.0)}) is False
        # The tmp bytes exist but the step was never published.
        assert spill.steps() == []
        assert [n for n in os.listdir(spill.path)
                if n.startswith(".tmp-")]

    def test_warm_promotes_newest_spill_into_memory(self, tmp_path):
        directory = str(tmp_path / "d")
        spill = tiers.LocalSpill(directory)
        spill.spill(2, snapshot_leaves(state(2)))
        spill.spill(4, snapshot_leaves(state(4)))
        assert tiers.TIER0.lookup(directory) is None
        assert tiers.warm(directory) == 4
        replica = tiers.TIER0.lookup(directory)
        assert replica["step"] == 4
        # Hot slot: warm is a no-op (the replica is already newest).
        assert tiers.warm(directory) is None
        tiers.TIER0.drop(directory)

    def test_latest_step_sees_every_tier(self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(2, state(2), force=True)
        mgr.wait()
        # A spill step newer than anything the store has committed
        # (e.g. the store save raced a preemption) still counts.
        mgr._spill.spill(6, snapshot_leaves(state(6)))
        assert mgr.latest_step() == 6
        mgr.close()

    def test_tier0_loss_drops_both_cheap_tiers(self, tmp_path):
        """The chaos ``tier0-loss`` seam drops the replica and the spill,
        as a new process on a new host would find them."""
        from polyaxon_tpu_torch import chaos

        mgr = manager(tmp_path)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        chaos.install(chaos.ChaosPlan.from_dict({"faults": [
            {"seam": "tier0-loss", "op": "drop"}]}))
        try:
            restored = mgr.restore(state(0))
            assert chaos.active_plan().done
        finally:
            chaos.uninstall()
        assert mgr._spill.steps() == []
        assert_state(restored, 4)
        assert mgr.last_restore_tier == tiers.TIER_STORE
        # The store win does not re-promote; the next save refills the
        # cheap tiers and the restore after it is a memory hit.
        assert tiers.TIER0.lookup(mgr.directory) is None
        mgr.save(6, state(6), force=True)
        mgr.wait()
        mgr.restore(state(0))
        assert mgr.last_restore_tier == tiers.TIER_MEMORY
        mgr.close()


# ================================================== the port's own format
class TestStoreFormat:
    def test_manifest_and_leaves_are_plain_numpy(self, tmp_path):
        """One directory per step: a manifest with path, dtype, shape,
        bytes and CRC-32 per leaf, and .npy leaves np.load reads; bf16 is
        stored as its 16-bit words, never cast."""
        mgr = manager(tmp_path)
        st = state(3)
        st["params"]["h"] = torch.tensor([[1.0, -2.5, 3e-3]] * 2,
                                         dtype=torch.bfloat16)
        mgr.save(3, st, force=True)
        mgr.close()
        step_dir = os.path.join(mgr.directory, "3")
        with open(os.path.join(step_dir, ck.MANIFEST)) as fh:
            manifest = json.load(fh)
        assert manifest["format"] == ck.FORMAT and manifest["step"] == 3
        paths = [e["path"] for e in manifest["leaves"]]
        assert paths == ["step", "params/w", "params/h", "opt_state/count",
                         "opt_state/mu/0"]
        h = manifest["leaves"][2]
        assert (h["dtype"], h["shape"], h["nbytes"]) == ("bfloat16", [2, 3],
                                                         12)
        raw = np.load(os.path.join(step_dir, "leaf_2.npy"))
        assert raw.dtype == np.uint16
        assert torch.equal(torch.from_numpy(raw.view(np.int16)).view(
            torch.bfloat16), st["params"]["h"])
        for i, entry in enumerate(manifest["leaves"]):
            arr = np.load(os.path.join(step_dir, f"leaf_{i}.npy"))
            assert zlib.crc32(arr.tobytes()) == entry["crc32"]
        assert int(np.load(os.path.join(step_dir, "leaf_0.npy"))) == 3

    def test_restored_tensors_are_byte_identical(self, tmp_path):
        """From the store (a new manager: no memory replica), every
        restored leaf's CRC-32 equals the manifest's."""
        gen = torch.Generator().manual_seed(0)
        st = {"step": 7, "params": {"w": torch.randn(64, 33, generator=gen),
                                    "b": torch.randn(5, generator=gen)
                                    .bfloat16()}}
        mgr = manager(tmp_path)
        mgr.save(7, st, force=True)
        mgr.close()
        tiers.TIER0.clear()
        tiers.LocalSpill(mgr.directory).drop_all()
        like = {"step": 0, "params": {"w": torch.zeros(64, 33),
                                      "b": torch.zeros(5).bfloat16()}}
        mgr = manager(tmp_path)
        got = mgr.restore(like)
        assert mgr.last_restore_tier == tiers.TIER_STORE
        manifest = ck.read_manifest(mgr.directory, 7)
        for entry, (_, leaf) in zip(manifest["leaves"], ck.flatten(got)):
            if isinstance(leaf, torch.Tensor):
                leaf = ck._tensor_bytes(leaf).numpy()
            else:
                leaf = np.asarray(leaf, np.int64)
            assert ck.crc32(leaf) == entry["crc32"], entry["path"]
        assert got["params"]["w"] is like["params"]["w"]  # filled in place
        mgr.close()

    def test_explicit_step_never_falls_back(self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(2, state(2), force=True)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        flip_byte(os.path.join(mgr.directory, "4", "leaf_1.npy"))
        with pytest.raises(ValueError, match="CRC"):
            mgr.restore(state(0), step=4)
        assert_state(mgr.restore(state(0), step=2), 2)
        assert mgr.last_restore_tier == tiers.TIER_STORE
        mgr.close()

    def test_truncated_or_mismatched_steps_fail_validation(self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(2, state(2), force=True)
        mgr.wait()
        with open(os.path.join(mgr.directory, "2", "leaf_1.npy"),
                  "r+b") as fh:
            fh.truncate(os.path.getsize(fh.name) - 4)
        with pytest.raises(ValueError, match="truncated"):
            mgr.restore(state(0), step=2)
        mgr.close()
        mgr = manager(tmp_path)
        mgr.save(3, state(3), force=True)
        mgr.wait()
        for bad in (state(0, n=9), {"step": 0}):
            with pytest.raises(ValueError):
                mgr.restore(bad, step=3)
        mgr.close()

    def test_max_to_keep_and_interval(self, tmp_path):
        mgr = manager(tmp_path, max_to_keep=2, interval_steps=3)
        assert [s for s in range(10) if mgr.should_save(s)] == [3, 6, 9]
        for step in (3, 6, 9):
            mgr.save(step, state(step))
        mgr.wait()
        assert mgr._list_steps() == [9, 6]
        assert mgr._spill.steps() == [9, 6]
        mgr.close()
        off = manager(tmp_path, enabled=False, interval_steps=1)
        assert not off.should_save(1)
        off.save(1, state(1))  # disabled: nothing written...
        assert off.latest_step() == 9
        off.save(12, state(12), force=True)  # ...unless forced
        assert off._list_steps()[0] == 12
        off.close()

    def test_killed_writer_leaves_only_ignored_tmp_names(self, tmp_path):
        """A writer killed mid-commit leaves ``.tmp-…-<pid>`` names: the
        listings ignore them, the next restore does not trip on them,
        and the next manager on the directory removes them once their
        writer is dead."""
        mgr = manager(tmp_path)
        mgr.save(2, state(2), force=True)
        mgr.close()
        dead = subprocess.run([sys.executable, "-c",
                               "import os; print(os.getpid())"],
                              capture_output=True, text=True).stdout.strip()
        store_tmp = os.path.join(mgr.directory, f".tmp-4-{dead}")
        os.makedirs(store_tmp)
        with open(os.path.join(store_tmp, "leaf_0.npy"), "wb") as fh:
            fh.write(b"\x93NUMPY half")
        spill_tmp = os.path.join(mgr.directory, tiers.SPILL_DIRNAME,
                                 f".tmp-4-{dead}.npz")
        with open(spill_tmp, "wb") as fh:
            fh.write(b"PK half")
        link_tmp = os.path.join(mgr.directory, tiers.SPILL_DIRNAME,
                                f".tmp-6-{dead}")
        os.makedirs(link_tmp)
        live_tmp = os.path.join(mgr.directory, f".tmp-6-{os.getppid()}")
        os.makedirs(live_tmp)
        assert mgr._list_steps() == [2] and mgr._spill.steps() == [2]
        tiers.TIER0.clear()
        mgr = manager(tmp_path)
        assert not os.path.exists(store_tmp)
        assert not os.path.exists(spill_tmp)
        assert not os.path.exists(link_tmp)
        assert os.path.exists(live_tmp)  # its writer is alive
        assert_state(mgr.restore(state(0)), 2)
        assert mgr.last_restore_tier == tiers.TIER_LOCAL
        mgr.close()

    def test_load_tree_reads_a_subtree(self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(5, state(5), force=True)
        mgr.close()
        step, tree = ck.load_tree(mgr.directory, only="params")
        assert step == 5 and set(tree) == {"params"}
        assert torch.equal(tree["params"]["w"], state(5)["params"]["w"])
        assert tree["params"]["h"].dtype == torch.bfloat16
        _, whole = ck.load_tree(mgr.directory)
        assert whole["opt_state"]["count"] == 5
        assert torch.equal(whole["opt_state"]["mu"]["0"], torch.zeros(4) + 5)
        with pytest.raises(FileNotFoundError):
            ck.load_tree(str(tmp_path / "nothing"))


class TestSnapshotIsolation:
    def test_async_save_snapshots_before_it_returns(self, tmp_path):
        """``save()`` returns with the state copied to host memory: an
        in-place update made before the publisher runs does not reach
        the checkpoint (the optimizer updates params in place)."""
        mgr = manager(tmp_path, async_save=True)
        gate = threading.Event()
        real = mgr._publish

        def gated(*args):
            assert gate.wait(30)
            real(*args)

        mgr._publish = gated
        st = state(4)
        mgr.save(4, st)
        with torch.no_grad():
            st["params"]["w"].add_(100.0)
            st["params"]["h"].mul_(3)
            st["opt_state"]["mu"][0].fill_(-1)
        st["step"] = 99
        gate.set()
        mgr.wait()
        tiers.TIER0.clear()
        mgr._spill.drop_all()
        assert_state(mgr.restore(state(0)), 4)
        assert mgr.last_restore_tier == tiers.TIER_STORE
        mgr.close()

    def test_snapshot_never_leaves_a_stale_replica(self, tmp_path):
        """The memory replica is the snapshot buffer itself: the next
        snapshot drops it before overwriting the buffer, so the replica
        is always the step it names."""
        mgr = manager(tmp_path, async_save=True)
        gate = threading.Event()
        real = mgr._publish

        def gated(*args):
            assert gate.wait(30)
            real(*args)

        for step in (2, 4, 6):
            mgr._publish = real if step == 2 else gated
            gate.clear()
            mgr.save(step, state(step))
            if step > 2:
                # Snapshot taken, publisher held: the old replica is gone.
                assert tiers.TIER0.lookup(mgr.directory) is None
                gate.set()
            mgr.wait()
            assert tiers.TIER0.lookup(mgr.directory)["step"] == step
            assert_state(mgr.restore(state(0)), step)
            assert mgr.last_restore_tier == tiers.TIER_MEMORY
        mgr.close()


class TestSpec:
    @pytest.mark.parametrize("spec", [
        {"enabled": True, "intervalSteps": 5, "maxToKeep": 2,
         "asyncSave": False, "restoreOnStart": False},
        {"enabled": True, "interval_steps": 5, "max_to_keep": 2,
         "async_save": False, "restore_on_start": False},
    ])
    def test_both_spellings(self, spec):
        got = CheckpointSpec.from_dict(spec)
        assert got == CheckpointSpec(enabled=True, interval_steps=5,
                                     max_to_keep=2, async_save=False,
                                     restore_on_start=False)

    def test_defaults_are_the_reference_schema(self):
        from polyaxon_tpu.polyflow.runs import V1JaxCheckpointing

        ref = V1JaxCheckpointing()
        got = CheckpointSpec.from_dict({})
        for field in dataclasses.fields(CheckpointSpec):
            assert getattr(got, field.name) == getattr(ref, field.name)
        # The compiler dumps the schema by alias; the port reads that.
        dumped = V1JaxCheckpointing(interval_steps=7, async_save=False) \
            .to_dict()
        assert CheckpointSpec.from_dict(dumped) == CheckpointSpec(
            interval_steps=7, async_save=False)
        with pytest.raises(ValueError, match="unknown"):
            CheckpointSpec.from_dict({"intervalStep": 3})


# ============================================== resume, against the JAX run
RUNTIME = dict(model="llama_tiny", dataset="lm_packed_synthetic", seq_len=32,
               global_batch_size=4, steps=5, log_every=1, learning_rate=3e-3,
               lr_schedule="cosine", warmup_steps=1, loss_chunk=16,
               attention_impl="xla", dtype="float32", seed=0)
CKPT = {"enabled": True, "intervalSteps": 2, "asyncSave": True}


def _stop_after(n_calls):
    """``should_stop`` that says stop on its ``n_calls``-th call (the
    loop calls it before each step after the warm-up)."""
    calls = [0]

    def should_stop():
        calls[0] += 1
        return calls[0] >= n_calls

    return should_stop


@pytest.fixture(scope="module")
def jax_params0():
    """JAX's initial llama_tiny weights for RUNTIME, as numpy."""
    import jax

    from polyaxon_tpu.models import get_model as jget_model
    from polyaxon_tpu.models import llama as jllama
    from polyaxon_tpu.parallel import build_mesh, rules_for_mesh
    from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
    from polyaxon_tpu.runtime.optim import build_optimizer as jbuild
    from polyaxon_tpu.runtime.step import build_init as jinit

    jcfg = JCfg.model_validate(RUNTIME)
    model = jget_model("llama_tiny",
                       **jcfg.model_overrides(jllama.LlamaConfig))
    mesh = build_mesh(axes={"dp": 1}, devices=jax.devices()[:1])
    with mesh:
        st = jinit(model, jbuild(jcfg), mesh, rules_for_mesh(mesh))(
            jax.random.key(jcfg.seed))
        return jax.tree.map(np.asarray, st["params"])


def _jax_run(art, should_stop=None):
    import jax

    from polyaxon_tpu.polyflow.runs import V1JAXJob
    from polyaxon_tpu.runtime.loop import run_jaxjob

    job = V1JAXJob.from_dict({"kind": "jaxjob", "mesh": {"axes": {"dp": 1}},
                              "checkpointing": CKPT, "runtime": RUNTIME})
    seen = {}
    result = run_jaxjob(job, artifacts_dir=str(art),
                        devices=jax.devices()[:1], should_stop=should_stop,
                        on_metrics=lambda s, v: seen.setdefault(s, {})
                        .update(v))
    return result, {s: v["loss"] for s, v in seen.items() if "loss" in v}


def _torch_run(art, monkeypatch, params0, should_stop=None):
    from polyaxon_tpu_torch.models import llama as tllama
    from polyaxon_tpu_torch.runtime import loop, step

    def build_init(model_def, optimizer, *, device, **kwargs):
        params = tllama.params_from_numpy(model_def.config, params0,
                                          device=device)
        return step.build_init(model_def, optimizer, device=device,
                               params=params, **kwargs)

    monkeypatch.setattr(loop, "build_init", build_init)
    job = {"kind": "jaxjob", "mesh": {"axes": {"dp": 1}},
           "checkpointing": CKPT, "runtime": RUNTIME}
    seen = {}
    result = loop.run_torchjob(job, artifacts_dir=str(art), device="cpu",
                               should_stop=should_stop,
                               on_metrics=lambda s, v: seen.setdefault(s, {})
                               .update(v))
    return result, {s: v["loss"] for s, v in seen.items() if "loss" in v}


def test_resume_matches_uninterrupted_and_jax(tmp_path, monkeypatch,
                                              jax_params0):
    from polyaxon_tpu import chaos as jax_chaos
    from polyaxon_tpu_torch import chaos as torch_chaos

    runs = {}
    for name, fn in (("jax", lambda art, stop=None: _jax_run(art, stop)),
                     ("torch", lambda art, stop=None: _torch_run(
                         art, monkeypatch, jax_params0, stop))):
        full, full_losses = fn(tmp_path / name / "full")
        cut, _ = fn(tmp_path / name / "cut", _stop_after(3))
        resumed, resumed_losses = fn(tmp_path / name / "cut")
        # The same interrupted run again, its latest step then corrupted
        # in every tier by each package's chaos ``corrupt_latest``: the
        # restore falls back a step.
        fn(tmp_path / name / "bad", _stop_after(3))
        chaos = jax_chaos if name == "jax" else torch_chaos
        chaos.install(chaos.ChaosPlan.from_dict({"faults": [
            {"seam": "checkpoint", "op": "corrupt_latest"}]}))
        try:
            fallback, fallback_losses = fn(tmp_path / name / "bad")
            assert chaos.active_plan().done
        finally:
            chaos.uninstall()
        runs[name] = (full, full_losses, cut, resumed, resumed_losses,
                      fallback, fallback_losses)

    audits = {}
    for name, (full, full_losses, cut, resumed, resumed_losses, fallback,
               fallback_losses) in runs.items():
        assert full.steps == 5 and cut.steps == 3
        assert sorted(full_losses) == [1, 2, 3, 4]
        assert resumed.steps == fallback.steps == 5
        assert sorted(resumed_losses) == sorted(fallback_losses) == [4]
        rel = 0.0 if name == "torch" else 1e-6
        for got in (resumed_losses[4], fallback_losses[4],
                    resumed.final_metrics["loss"],
                    fallback.final_metrics["loss"]):
            assert got == pytest.approx(full_losses[4], rel=rel, abs=0), name
        audits[name] = [(r.restored_from_step, r.restore_skipped_steps,
                         r.restore_tier) for r in (resumed, fallback)]
    assert audits["torch"] == audits["jax"] == [(3, [], "0"),
                                                (3, [3], "1")]
    jfull, tfull = runs["jax"][1], runs["torch"][1]
    for s in jfull:
        assert tfull[s] == pytest.approx(jfull[s], abs=1e-4), s
    assert runs["torch"][3].final_metrics["loss"] == pytest.approx(
        runs["jax"][3].final_metrics["loss"], abs=1e-4)


def test_new_process_resume_reads_the_spill(tmp_path, monkeypatch):
    """A rerun in a new process has no memory replica: it restores from
    the spill (or the store), and a run already at its last step returns
    at once."""
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    job = {"kind": "jaxjob", "checkpointing": CKPT,
           "runtime": dict(RUNTIME, steps=4)}
    first = run_torchjob(job, artifacts_dir=str(tmp_path), device="cpu",
                         should_stop=_stop_after(2))
    assert first.steps == 2 and first.checkpoint["bytes"] > 0
    assert set(first.checkpoint["commit_s"]) == {"0", "1", "2"}
    tiers.TIER0.clear()  # what a new process starts with
    second = run_torchjob(job, artifacts_dir=str(tmp_path), device="cpu")
    assert (second.restored_from_step, second.restore_tier) == (2, "1")
    assert second.steps == 4
    assert second.checkpoint["restore_s"]["1"][0] > 0
    tiers.TIER0.clear()
    third = run_torchjob(job, artifacts_dir=str(tmp_path), device="cpu")
    assert third.steps == 4 and third.restored_from_step == 4
    assert third.wall_time == 0.0


def test_profile_steps_trace_stays_off_the_clock(tmp_path, monkeypatch):
    """``profile_steps``: a torch.profiler trace of each listed step in
    ``<artifacts>/profile``, and the profiled step is not among the
    timed steps (throughput counts only the others)."""
    from polyaxon_tpu_torch.runtime import loop

    job = {"kind": "jaxjob", "checkpointing": {"enabled": False},
           "runtime": dict(RUNTIME, steps=4, profile_steps=[2])}
    seen = {}
    result = loop.run_torchjob(job, artifacts_dir=str(tmp_path),
                               device="cpu",
                               on_metrics=lambda s, v: seen.update({s: v}))
    traces = os.listdir(tmp_path / "profile")
    assert traces == ["step_2.json"]
    with open(tmp_path / "profile" / "step_2.json") as fh:
        assert json.load(fh)["traceEvents"]
    # Timed steps: 1 and 3 (2 is profiled, 0 is the warm-up). The
    # profiled step's emission carries no rate: its window is empty.
    assert result.throughput == pytest.approx(
        result.units_per_step * 2 / result.wall_time, rel=1e-9)
    assert "tokens_per_sec" in seen[1] and "tokens_per_sec" in seen[3]
    assert "tokens_per_sec" not in seen[2] and "loss" in seen[2]


def test_serving_a_checkpoint_equals_serving_the_params(tmp_path):
    """``load_params(checkpoint=...)`` on a 2-step run's checkpoint gives
    the params the run trained (replayed here from the same seed and
    batches), cast as serving casts them, and the same tokens."""
    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.models import llama as tllama
    from polyaxon_tpu_torch.runtime import data as tdata
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.loop import run_torchjob
    from polyaxon_tpu_torch.runtime.optim import build_optimizer
    from polyaxon_tpu_torch.runtime.step import build_init, build_train_step
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import load_params

    runtime = dict(RUNTIME, steps=2, dtype="float32")
    run_torchjob({"kind": "jaxjob", "checkpointing": CKPT,
                  "runtime": runtime}, artifacts_dir=str(tmp_path),
                 device="cpu")
    cfg, served = load_params("llama_tiny",
                              checkpoint=str(tmp_path / "checkpoints"),
                              device="cpu")

    rcfg = RuntimeConfig.from_dict(runtime)
    model_def = get_model("llama_tiny", dtype=torch.float32, loss_chunk=16,
                          attention_impl="xla", max_seq_len=32)
    opt = build_optimizer(rcfg)
    st = build_init(model_def, opt, device="cpu")(0)
    train = build_train_step(model_def, opt)
    batches = tdata.get_dataset("lm_packed_synthetic", batch_size=4,
                                seq_len=32, vocab_size=256, seed=0)
    for _ in range(2):
        st, _ = train(st, {k: torch.from_numpy(v)
                           for k, v in next(batches).items()})
    flat_served = dict(ck.flatten(served))
    for path, p in ck.flatten(st["params"]):
        want = p.detach().to(flat_served[path].dtype)
        assert torch.equal(flat_served[path], want), path
        gain = path.split("/")[-1] in ("attn_norm", "mlp_norm",
                                       "final_norm")
        assert flat_served[path].dtype == (torch.float32 if gain
                                           else cfg.dtype)

    def as_numpy(tree):
        return {k: as_numpy(v) if isinstance(v, dict)
                else v.detach().numpy() for k, v in tree.items()}

    in_memory = tllama.params_from_numpy(cfg, as_numpy(st["params"]),
                                         device="cpu", param_dtype=cfg.dtype)
    prompts = [[5, 17, 3, 9], [1, 2, 3, 4, 5, 6, 7]]
    outs = []
    for params in (served, in_memory):
        eng = ContinuousBatchingEngine("llama_tiny", cfg, params, slots=2,
                                       kv="paged", page_size=4,
                                       device="cpu")
        try:
            outs.append([r.wait(timeout=120) for r in
                         [eng.submit(p, 6) for p in prompts]])
        finally:
            eng.stop()
    assert outs[0] == outs[1] and all(len(o) == 6 for o in outs[0])

    with pytest.raises(ValueError, match="does not match"):
        load_params("llama_tiny_tied",
                    checkpoint=str(tmp_path / "checkpoints"), device="cpu")
