"""One plan process across several local devices (the port's local
gangs, ``runtime/local_gang.py``), held against the JAX package.

A JAX process drives every device it sees: ``run_jaxjob`` draws
``global_batch // process_count`` rows once and shards them over the
process's devices. The port's process drives one device, so a process
that holds D devices trains as a gang of D ranks, each taking its row
block of the process's rows (``rank_rows``).

- ``rank_rows`` against the reference's layout of the global batch
  (process-major copies of each process's rows, microbatch m its m-th
  contiguous slice, row blocks in mesh order), at 1 and at D ranks per
  process;
- a one-process ``{dp: 2, fsdp: 2}`` job over 4 CPU devices trains as 4
  ranks, on distinct rows: its losses equal ``run_jaxjob`` on a
  4-device mesh from JAX's initial weights (abs 1e-4, the gang tests'
  tolerance), and ``units_per_step`` is the global batch's tokens;
- a plan of 2 processes x 2 devices through the agent: 4 ranks, each
  process's rows drawn once (the reference's duplicated rows per
  process, ROADMAP.md Queue 3), equal to the JAX job over one process's
  rows;
- the default of one CPU device leaves a run in the calling process,
  unchanged;
- a stop that only rank 0 sees stops both ranks at one step; a rank that
  fails takes the gang down with it; a rank whose supervisor is gone
  exits.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch.agent import Agent
from polyaxon_tpu_torch.controlplane import ControlPlane
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.parallel import bootstrap
from polyaxon_tpu_torch.parallel.mesh import build_mesh, row_block
from polyaxon_tpu_torch.runtime import local_gang
from polyaxon_tpu_torch.runtime.loop import run_torchjob
from polyaxon_tpu_torch.runtime.step import rank_rows
from tests.torch_deadline import deadline
from tests.torch_dist_cases import CPU_LAUNCHER, ENV_START_PARAMS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model": "llama_tiny", "dataset": "lm_synthetic", "seq_len": 64,
        "log_every": 1}
CPU_RANK = [sys.executable, "-c", CPU_LAUNCHER]


@pytest.fixture()
def cpu_env(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def start_params(tmp_path, monkeypatch, runtime) -> None:
    """Every rank (``CPU_LAUNCHER``) starts from JAX's initial weights."""
    from tests.test_torch_compile_launch import jax_initial_params

    path = tmp_path / "params0.pkl"
    with open(path, "wb") as fh:
        pickle.dump(jax_initial_params(runtime), fh)
    monkeypatch.setenv(ENV_START_PARAMS, str(path))


def jax_losses(job: dict, devices) -> tuple[dict, object]:
    from polyaxon_tpu.polyflow import V1JAXJob
    from polyaxon_tpu.runtime.loop import run_jaxjob

    seen = {}
    result = run_jaxjob(V1JAXJob.from_dict({"kind": "jaxjob", **job}),
                        devices=devices,
                        on_metrics=lambda s, v: seen.__setitem__(
                            s, v["loss"]) if "loss" in v else None)
    return seen, result


# ---------------------------------------------------------------- rows
ROW_CASES = [
    # (mesh axes, plan processes, microbatches)
    ({"dp": 4}, 1, 1),
    ({"dp": 2, "fsdp": 2}, 1, 2),
    ({"dp": 2, "tp": 2}, 1, 2),
    ({"dp": 4}, 2, 1),
    ({"dp": 2, "fsdp": 2}, 2, 2),
    ({"dp": 4}, 4, 2),           # one rank per process, as before
    ({"dp": 2, "tp": 2}, 2, 1),
]


@pytest.mark.parametrize("axes,n_proc,accum", ROW_CASES)
def test_rank_rows_lay_out_the_reference_global_batch(axes, n_proc, accum,
                                                      monkeypatch):
    """Every rank's microbatch m, block by block, is the m-th contiguous
    slice of the reference's global batch: the processes' rows one after
    another, each process's rows the same draw."""
    mesh = build_mesh(axes=axes, devices=range(4))
    per = 4 // n_proc  # ranks per plan process
    global_batch = 16
    drawn = np.arange(global_batch // n_proc)  # a process's rows, by id
    reference = np.concatenate([drawn] * n_proc)
    n_blocks = row_block(mesh, 0)[0]
    got = {}
    for rank in range(4):
        monkeypatch.setattr(bootstrap, "rank", lambda r=rank: r)
        first = rank // per * per
        local = len({row_block(mesh, r)[1] for r in range(first, first + per)})
        n, block = row_block(mesh)
        assert (n, block) == row_block(mesh, rank)
        got[rank] = (block, rank_rows({"x": drawn}, mesh, accum, local)["x"])
    rows = global_batch // n_blocks if n_blocks > 1 else len(drawn)
    for rank, (block, mine) in got.items():
        assert len(mine) == rows
        for m in range(accum):
            micro = len(mine) // accum
            want_slice = reference[m * len(reference) // accum:
                                   (m + 1) * len(reference) // accum]
            if n_blocks > 1:
                size = len(want_slice) // n_blocks
                want = want_slice[block * size:(block + 1) * size]
            else:
                want = drawn[m * micro:(m + 1) * micro]
            np.testing.assert_array_equal(mine[m * micro:(m + 1) * micro],
                                          want)


def test_local_devices_follow_the_env_contract():
    assert bootstrap.local_devices("cpu", env={}) == [0]
    assert bootstrap.local_devices(
        "cpu", env={bootstrap.ENV_LOCAL_DEVICE_IDS: "0,1,2"}) == [0, 1, 2]
    assert bootstrap.local_devices(
        "cpu", env={bootstrap.ENV_LOCAL_DEVICE_IDS: "3"}) == [3]


def test_rank_envs_number_the_ranks_of_every_process():
    envs = local_gang.rank_envs(
        {}, devices=[0, 1], device_type="cpu", coordinator="h:1",
        stop_file="/s", process_id=1, num_processes=2,
        mesh_axes={"dp": 4})
    assert [(e[bootstrap.ENV_PROCESS_ID], e[bootstrap.ENV_NUM_PROCESSES],
             e[bootstrap.ENV_LOCAL_DEVICE_IDS],
             e[bootstrap.ENV_RANKS_PER_PROCESS]) for e in envs] == \
        [("2", "4", "0", "2"), ("3", "4", "1", "2")]
    assert all(json.loads(e[local_gang.ENV_MESH_AXES]) == {"dp": 4}
               for e in envs)
    assert all(local_gang.supervised(e) for e in envs)


# ------------------------------------------------------- against JAX
@deadline(150)
def test_one_process_over_four_devices_matches_jax(tmp_path, monkeypatch,
                                                   cpu_env, cpu_devices):
    job = {"runtime": {**TINY, "steps": 4, "global_batch_size": 8,
                       "dtype": "float32"},
           "mesh": {"axes": {"dp": 2, "fsdp": 2}}}
    start_params(tmp_path, monkeypatch, job["runtime"])
    seen = {}
    art = str(tmp_path / "run")
    result = run_torchjob(job, devices=[0, 1, 2, 3], device="cpu",
                          artifacts_dir=art, gang_command=CPU_RANK,
                          on_metrics=lambda s, v: seen.__setitem__(
                              s, v["loss"]))
    logs = sorted(os.listdir(os.path.join(art, "logs")))
    assert logs == [f"rank-{r}.log" for r in range(4)]
    for r in range(4):
        with open(os.path.join(art, "logs", f"rank-{r}.log")) as fh:
            assert "mesh axes={'dp': 2, 'fsdp': 2} devices=4" in fh.read()
    want, jresult = jax_losses(job, cpu_devices[:4])
    assert sorted(seen) == sorted(want) == [1, 2, 3]
    for step, loss in want.items():
        assert seen[step] == pytest.approx(loss, abs=1e-4), step
    assert result.steps == 4
    assert result.units_per_step == 8 * 64 == jresult.units_per_step


@deadline(150)
def test_two_processes_of_two_devices_through_the_agent(
        tmp_path, monkeypatch, cpu_env, cpu_devices):
    from tests.test_torch_gang import submit_on_cpu

    runtime = {**TINY, "steps": 3, "global_batch_size": 16,
               "dtype": "float32"}
    start_params(tmp_path, monkeypatch, runtime)
    monkeypatch.setenv(bootstrap.ENV_LOCAL_DEVICE_IDS, "0,1")
    plane = ControlPlane(str(tmp_path / "home"))
    record = submit_on_cpu(plane, {
        "kind": "component", "name": "two-by-two",
        "run": {"kind": "jaxjob", "numProcesses": 2, "runtime": runtime,
                "mesh": {"axes": {"dp": 4}}}})
    status = Agent(plane).run_until_done(record.uuid, timeout=120)
    art = plane.run_artifacts_dir(record.uuid)
    logs = set(os.listdir(os.path.join(art, "logs")))
    tail = plane.streams.read_logs(record.uuid, "main-0.log")[0][-3000:]
    assert status == V1Statuses.SUCCEEDED, tail
    assert {f"rank-{r}.log" for r in range(4)} <= logs
    port = {e["step"]: e["value"] for e in plane.streams.get_metrics(
        record.uuid, ["loss"])["loss"]}
    outputs = plane.streams.get_outputs(record.uuid)
    # Each process draws 8 rows; the reference's global batch holds them
    # twice, so its loss is the JAX job's over those 8 rows.
    want, _ = jax_losses({"runtime": dict(runtime, global_batch_size=8),
                          "mesh": {"axes": {"dp": 4}}}, cpu_devices[:4])
    assert sorted(port) == sorted(want) == [1, 2]
    for step, loss in want.items():
        assert port[step] == pytest.approx(loss, abs=1e-4), step
    assert outputs["steps"] == 3


@deadline(60)
def test_one_cpu_device_by_default_runs_in_process(tmp_path):
    job = {"runtime": {**TINY, "steps": 3, "global_batch_size": 4,
                       "dtype": "float32"}}
    a = run_torchjob(job, device="cpu", artifacts_dir=str(tmp_path / "a"))
    b = run_torchjob(job, device="cpu", devices=[0],
                     artifacts_dir=str(tmp_path / "b"))
    assert not os.path.exists(tmp_path / "a" / "logs")  # no ranks
    assert a.final_metrics == b.final_metrics
    assert a.units_per_step == b.units_per_step == 4 * 64


# ------------------------------------------------------ stop and fail
@deadline(90)
def test_a_stop_rank_0_sees_stops_both_ranks_at_one_step(tmp_path, cpu_env):
    job = {"runtime": {**TINY, "steps": 200, "global_batch_size": 4,
                       "dtype": "float32"}}
    seen = []
    art = str(tmp_path / "run")
    result = run_torchjob(job, devices=[0, 1], device="cpu",
                          artifacts_dir=art,
                          on_metrics=lambda s, v: seen.append(s),
                          should_stop=lambda: len(seen) >= 3)
    assert 3 <= result.steps < 200
    stops = []
    for r in range(2):
        with open(os.path.join(art, "logs", f"rank-{r}.log")) as fh:
            lines = [ln for ln in fh if "stop requested at step" in ln]
        assert len(lines) == 1, r
        stops.append(int(lines[0].rsplit(" ", 1)[1]))
    assert stops[0] == stops[1] == result.steps
    assert result.stop_check_ms > 0


@deadline(60)
def test_a_failed_rank_takes_the_gang_down(tmp_path):
    rank = (f"import os, sys, time; "
            f"sys.exit(3) if os.environ['{bootstrap.ENV_PROCESS_ID}'] == '1'"
            f" else time.sleep(120)")
    job = {"runtime": {**TINY, "steps": 2}}
    with pytest.raises(RuntimeError, match="local gang rank 1 exited with 3"):
        run_torchjob(job, devices=[0, 1, 2], device="cpu",
                     artifacts_dir=str(tmp_path),
                     gang_command=[sys.executable, "-c", rank])


def test_a_rank_whose_supervisor_is_gone_exits(cpu_env):
    code = ("from polyaxon_tpu_torch.runtime import local_gang; "
            "local_gang.die_with_parent(); print('alive')")
    env = {**os.environ, local_gang.ENV_GANG_PARENT: "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1 and "alive" not in out.stdout
