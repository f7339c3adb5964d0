"""The port's checkpoint chaos seams (``runtime/checkpoint.py``,
``runtime/tiers.py``), held against the JAX package's, on the CPU.

- The probe: two saved steps, one fault installed, then ``restore``, on
  each package's ``TieredCheckpointManager`` (the JAX one over Orbax):
  ``checkpoint/corrupt_latest`` gives the older step from the spill with
  the newer one skipped, ``tier0-loss/drop`` the newer step from the
  store, and the audit (step, tier, skipped, the fault's budget spent)
  is equal in both packages.
- The cases of ``tests/test_chaos.py``'s ``TestCheckpointFallback`` on
  the port's plain manager, ``tests/test_checkpoint_tiers.py``'s
  every-tier-corrupt case with the fault installed, and its chaos
  ``tier0-loss`` case.
- Every restore adds one sample to the catalogued
  ``polyaxon_checkpoint_restore_seconds{tier}`` and every commit one to
  ``polyaxon_checkpoint_save_seconds{tier, mode}``, under the JAX
  package's labels; a fault opens and closes its ``chaos.<seam>``
  window in the default metrics-history ring.
- The spill hard-links each store step's files, and the fault rewrites
  the newest store step's files in place: no file of an older spill
  step shares an inode with them, so the older step still restores.
- ``tests/test_chaos.py``'s gauntlet (a transient store fault, a gang
  kill after two checkpoints, a corrupted latest checkpoint) on the
  port's plane, with ``Agent(..., in_process=True, device="cpu")``.
"""

import os
import time

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch import chaos
from polyaxon_tpu_torch.obs import history as obs_history
from polyaxon_tpu_torch.obs import metrics as obs_metrics
from polyaxon_tpu_torch.runtime import tiers
from polyaxon_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                   CheckpointSpec,
                                                   TieredCheckpointManager)

CORRUPT = {"seam": "checkpoint", "op": "corrupt_latest"}
TIER0_LOSS = {"seam": "tier0-loss", "op": "drop"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_seams():
    from polyaxon_tpu import chaos as jax_chaos

    chaos.uninstall()
    jax_chaos.uninstall()
    obs_metrics.REGISTRY.reset()
    yield
    chaos.uninstall()
    jax_chaos.uninstall()
    tiers.TIER0.clear()
    obs_metrics.REGISTRY.reset()


def install(*faults):
    chaos.install(chaos.ChaosPlan.from_dict({"faults": list(faults)}))


def state(step: int):
    return {"step": step,
            "params": {"w": torch.arange(8, dtype=torch.float32) + step,
                       "h": torch.full((2, 3), float(step),
                                       dtype=torch.bfloat16)}}


def step_of(restored) -> int:
    assert torch.equal(restored["params"]["w"],
                       torch.arange(8, dtype=torch.float32)
                       + restored["step"])
    return int(restored["step"])


def manager(tmp_path, cls=TieredCheckpointManager, **spec_over):
    spec = dict(enabled=True, async_save=False, max_to_keep=20)
    spec.update(spec_over)
    return cls(str(tmp_path / "ckpt"), CheckpointSpec(**spec))


def restore_samples() -> dict:
    family = obs_metrics.REGISTRY.snapshot().get(
        "polyaxon_checkpoint_restore_seconds") or {"series": {}}
    return {tier: s["count"] for tier, s in family["series"].items()}


# ================================================================= probe
def _jax_probe(tmp_path, fault):
    from polyaxon_tpu import chaos as jax_chaos
    from polyaxon_tpu.polyflow.runs import V1JaxCheckpointing
    from polyaxon_tpu.runtime.checkpoint import (
        TieredCheckpointManager as JaxTiered)

    def jstate(step):
        return {"step": np.asarray(step, np.int32),
                "params": {"w": np.arange(8, dtype=np.float32) + step}}

    mgr = JaxTiered(str(tmp_path / "jax"), V1JaxCheckpointing(
        enabled=True, async_save=False, max_to_keep=20))
    for step in (1, 2):
        mgr.save(step, jstate(step), force=True)
        mgr.wait()
    jax_chaos.install(jax_chaos.ChaosPlan.from_dict({"faults": [fault]}))
    try:
        restored = mgr.restore(jstate(0))
        done = jax_chaos.active_plan().done
    finally:
        jax_chaos.uninstall()
        mgr.close()
    return (int(restored["step"]), mgr.last_restore_tier,
            mgr.last_restore_skipped, done)


def _torch_probe(tmp_path, fault):
    mgr = manager(tmp_path)
    for step in (1, 2):
        mgr.save(step, state(step), force=True)
        mgr.wait()
    install(fault)
    try:
        restored = mgr.restore(state(0))
        done = chaos.active_plan().done
    finally:
        chaos.uninstall()
        mgr.close()
    return (step_of(restored), mgr.last_restore_tier,
            mgr.last_restore_skipped, done)


@pytest.mark.parametrize("fault,expected", [
    (CORRUPT, (1, "1", [2], True)),
    (TIER0_LOSS, (2, "2", [], True)),
], ids=["corrupt_latest", "tier0-loss"])
def test_probe_equals_the_reference(tmp_path, fault, expected):
    assert _torch_probe(tmp_path, fault) == expected
    assert _jax_probe(tmp_path, fault) == expected


# ====================================================== plain manager
class TestCheckpointFallback:
    """``tests/test_chaos.py``'s ``TestCheckpointFallback`` on the port's
    store-only manager."""

    def test_corrupt_latest_falls_back_to_older(self, tmp_path):
        mgr = manager(tmp_path, cls=CheckpointManager)
        mgr.save(2, state(2), force=True)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        assert mgr.latest_step() == 4
        install(CORRUPT)
        restored = mgr.restore(state(0))
        assert step_of(restored) == 2
        assert mgr.last_restore_skipped == [4]
        # The corrupt step was culled so the next save/restore is clean.
        assert mgr.latest_step() == 2
        mgr.close()
        assert chaos.active_plan().done
        assert restore_samples() == {"2": 1}

    def test_all_steps_corrupt_raises(self, tmp_path):
        mgr = manager(tmp_path, cls=CheckpointManager)
        mgr.save(2, state(2), force=True)
        mgr.wait()
        install(CORRUPT)
        with pytest.raises(RuntimeError, match="no restorable checkpoint"):
            mgr.restore(state(0))
        mgr.close()
        assert restore_samples() == {}


# ======================================================= tiered manager
class TestTieredChaos:
    def test_all_tiers_corrupt_at_latest_falls_to_older_clean_step(
            self, tmp_path):
        """``tests/test_checkpoint_tiers.py``'s case: step 4 corrupt in
        every tier (the replica by hand, the store by the fault, which
        rewrites the files the spill's step 4 links)."""
        mgr = manager(tmp_path)
        mgr.save(2, state(2), force=True)
        mgr.wait()
        mgr.save(4, state(4), force=True)
        mgr.wait()
        tiers.TIER0.publish(mgr.directory, 4,
                            {"leaf_0": np.zeros(3, np.float32)})
        install(CORRUPT)
        restored = mgr.restore(state(0))
        assert step_of(restored) == 2
        # Step 4 failed across ALL tiers -> the cross-tier culling audit.
        assert mgr.last_restore_skipped == [4]
        # Step 2 still lives in the spill (SPILL_KEEP=2): tier 1 won.
        assert mgr.last_restore_tier == tiers.TIER_LOCAL
        # Poisoned tiers were culled: the next restore never retries 4.
        assert mgr.latest_step() == 2
        mgr.close()

    def test_chaos_tier0_loss_drops_both_cheap_tiers(self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        install(TIER0_LOSS)
        restored = mgr.restore(state(0))
        assert step_of(restored) == 4
        assert mgr.last_restore_tier == tiers.TIER_STORE
        assert chaos.active_plan().done
        # Budget spent: the next restore keeps its cheap tiers. (The
        # store win does not re-promote; only a spill win does.)
        mgr.save(6, state(6), force=True)
        mgr.wait()
        mgr.restore(state(0))
        assert mgr.last_restore_tier == tiers.TIER_MEMORY
        mgr.close()

    def test_older_spill_step_shares_no_inode_with_the_corrupted_step(
            self, tmp_path):
        mgr = manager(tmp_path)
        for step in (2, 4):
            mgr.save(step, state(step), force=True)
            mgr.wait()
        store4 = os.path.join(mgr.directory, "4")
        spill2 = os.path.join(mgr._spill.path, "2")
        corrupted = {os.stat(os.path.join(store4, n)).st_ino
                     for n in os.listdir(store4)}
        older = {os.stat(os.path.join(spill2, n)).st_ino
                 for n in os.listdir(spill2)}
        assert corrupted and older and not corrupted & older
        before = {n: open(os.path.join(spill2, n), "rb").read()
                  for n in os.listdir(spill2)}
        tiers.TIER0.drop(mgr.directory)  # make the spill the first tier
        install(CORRUPT)
        restored = mgr.restore(state(0))
        assert (step_of(restored), mgr.last_restore_tier) == (2, "1")
        assert {n: open(os.path.join(spill2, n), "rb").read()
                for n in os.listdir(spill2)} == before
        mgr.close()

    def test_each_restore_and_commit_is_one_histogram_sample(self,
                                                             tmp_path):
        mgr = manager(tmp_path, async_save=True)
        for step in (1, 2):
            mgr.save(step, state(step), force=True)
            mgr.wait()
        saves = obs_metrics.REGISTRY.snapshot()[
            "polyaxon_checkpoint_save_seconds"]
        assert saves["labels"] == ["tier", "mode"]
        assert {k: s["count"] for k, s in saves["series"].items()} == {
            "0,async": 2, "1,async": 2, "2,async": 2}
        mgr.restore(state(0))                      # tier 0
        tiers.TIER0.drop(mgr.directory)
        mgr.restore(state(0))                      # tier 1
        install(TIER0_LOSS)
        mgr.restore(state(0))                      # tier 2
        assert restore_samples() == {"0": 1, "1": 1, "2": 1}
        assert {t: len(v) for t, v in mgr.restore_seconds.items()} == {
            "0": 1, "1": 1, "2": 1}
        mgr.close()

    def test_a_fault_opens_and_closes_its_history_window(self, tmp_path):
        mgr = manager(tmp_path)
        mgr.save(2, state(2), force=True)
        mgr.save(4, state(4), force=True)
        mgr.wait()
        install(CORRUPT)
        mgr.restore(state(0))
        (window,) = [w for w in obs_history.default_history().windows()
                     if w["name"] == "chaos.checkpoint"]
        assert window["end"] is not None
        assert window["start"] <= window["end"]
        mgr.close()


# ============================================================= gauntlet
def drive(agent, plane, uuid, until, timeout=240.0, poll=0.03):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        agent.reconcile_once()
        record = plane.get_run(uuid)
        if until(record):
            return record
        time.sleep(poll)
    raise AssertionError(
        f"run {uuid} never satisfied the predicate; last status "
        f"{plane.get_run(uuid).status}: {plane.get_statuses(uuid)}")


def test_one_run_survives_store_fault_kill_and_corrupt_ckpt(tmp_path,
                                                            monkeypatch):
    """``tests/test_chaos.py``'s gauntlet on the port's plane: ONE
    jaxjob run rides through (a) a transient store fault during artifact
    init, (b) a gang-member kill after two checkpoints exist, and (c) a
    corrupted latest checkpoint on resume — and still reaches SUCCEEDED
    with restored_from_step set from the OLDER checkpoint. The port's
    mesh is one device (the reference's is 8)."""
    from polyaxon_tpu_torch.agent import Agent
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.fs import get_store
    from polyaxon_tpu_torch.lifecycle import V1Statuses

    monkeypatch.setenv("POLYAXON_TPU_BACKOFF_BASE", "0.05")
    monkeypatch.setenv("POLYAXON_TPU_BACKOFF_MAX", "2")
    monkeypatch.setenv("POLYAXON_TPU_STORE_RETRY_BASE", "0.01")
    get_store("memory://chaos-gauntlet").write_bytes("vocab.txt", b"tokens")
    chaos.install(chaos.ChaosPlan.from_dict({"seed": 7, "faults": [
        {"seam": "store", "op": "*", "at": 1, "times": 1},
        {"seam": "gang", "op": "kill", "config": {"min_checkpoints": 2}},
        CORRUPT,
    ]}))
    plane = ControlPlane(str(tmp_path / "home"))
    record = plane.submit({
        "kind": "operation",
        "termination": {"maxRetries": 2},
        "component": {
            "name": "gauntlet",
            "run": {
                "kind": "jaxjob",
                "numProcesses": 1,
                "environment": {"restartPolicy": "on_failure"},
                "init": [{"artifacts": {"path": "memory://chaos-gauntlet"}}],
                "mesh": {"axes": {"dp": 1}},
                "checkpointing": {"enabled": True, "intervalSteps": 2,
                                  "asyncSave": False,
                                  "restoreOnStart": True},
                "runtime": {"model": "llama_tiny",
                            "dataset": "lm_synthetic", "steps": 6,
                            "seq_len": 64, "global_batch_size": 8,
                            "dtype": "float32"},
            },
        },
    })
    agent = Agent(plane, in_process=True, device="cpu")

    def settled(rec):
        if rec.status == V1Statuses.SUCCEEDED:
            return True
        reasons = [c.get("reason") for c in plane.get_statuses(rec.uuid)]
        assert "RetriesExhausted" not in reasons, reasons
        return False

    final = drive(agent, plane, record.uuid, settled, timeout=420)
    assert final.status == V1Statuses.SUCCEEDED
    plan = chaos.active_plan()
    assert plan.done, f"unconsumed faults; fired: {plan.consumed}"
    seams = [c["seam"] for c in plan.consumed]
    assert (seams.count("store"), seams.count("gang"),
            seams.count("checkpoint")) == (1, 1, 1)
    # The kill consumed exactly one restart, through the backoff gate.
    assert final.retries == 1
    assert len(final.meta["backoff"]["delays"]) == 1
    assert "retrying" in [c["type"] for c in plane.get_statuses(
        record.uuid)]
    # Resume restored from the OLDER checkpoint (label 2 → state step
    # 3), skipping the corrupted latest (label 4), and surfaced both the
    # outputs audit and a WARNING condition.
    outputs = plane.streams.get_outputs(record.uuid)
    assert outputs["steps"] == 6
    assert outputs["restored_from_step"] == 3
    assert outputs["restore_skipped_steps"] == [4]
    warning = [c for c in plane.get_statuses(record.uuid)
               if c["type"] == "warning"]
    assert warning and warning[-1]["reason"] == "CheckpointFallback"
    assert "4" in warning[-1]["message"]
    assert os.path.exists(os.path.join(plane.run_artifacts_dir(
        record.uuid), "inputs", "artifacts", "vocab.txt"))
    # The report attributes the restore and the faults.
    report = plane.report(record.uuid)
    assert report["phases"]["restore"]["skipped_steps"] == [4]
    assert report["attempts"] == 2
