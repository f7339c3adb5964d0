"""The port's compiler (``polyaxon_tpu_torch.compiler``) and connection
catalog against the JAX package's, on the CPU.

Every Polyaxonfile of ``tests/test_torch_polyaxonfile.py`` (with no
preset and with each preset, a matrix operation with one trial bound) is
checked, resolved and compiled by both packages. The launch plans must
be equal dict for dict (``to_dict()``), the job spec in
``POLYAXON_JAXJOB_SPEC`` compared as parsed JSON, once three module names
of the JAX package's plan are replaced by the port's:
``polyaxon_tpu.runtime.launch``, ``polyaxon_tpu.sidecar`` and
``polyaxon_tpu.utils.watchloop``. Where the JAX package refuses, the port
must refuse with the same exception class name and message.
"""

import json
import os

import pytest

from polyaxon_tpu import compiler as jcomp
from polyaxon_tpu import connections as jconn
from polyaxon_tpu import polyaxonfile as jpf
from polyaxon_tpu.parallel import bootstrap as jboot
from polyaxon_tpu.polyaxonfile import reader as jreader
from polyaxon_tpu.polyflow import V1Component as JComponent
from polyaxon_tpu_torch import compiler as tcomp
from polyaxon_tpu_torch import connections as tconn
from polyaxon_tpu_torch import polyaxonfile as tpf
from polyaxon_tpu_torch.compiler import compile as tcompile
from polyaxon_tpu_torch.polyaxonfile import reader as treader
from polyaxon_tpu_torch.polyflow import V1Component as TComponent
from tests.test_torch_polyaxonfile import (PRESETS, REPO, SPECS, outcome,
                                           preset_list, spec_source,
                                           trial_params)

RENAMES = {"polyaxon_tpu.runtime.launch": "polyaxon_tpu_torch.runtime.launch",
           "polyaxon_tpu.sidecar": "polyaxon_tpu_torch.sidecar",
           "polyaxon_tpu.utils.watchloop": "polyaxon_tpu_torch.utils.watchloop"}
ENV_SPEC = "POLYAXON_JAXJOB_SPEC"

CATALOG = [
    {"name": "alerts", "kind": "slack",
     "schema": {"url": "https://hooks.example/alerts"}},
    {"name": "repo", "kind": "git",
     "schema": {"url": "https://git.example/trainer.git"}},
    {"name": "store", "kind": "host_path",
     "schema": {"hostPath": "/mnt/store"}, "env": {"STORE_RO": "1"}},
]
BUILDER = {"kind": "component", "name": "builder",
           "inputs": [{"name": "destination", "type": "str",
                       "toEnv": "BUILD_DEST"}],
           "run": {"kind": "job", "container": {
               "image": "kaniko", "command": ["sh", "-c",
                                              "echo building $BUILD_DEST"]}}}


def comparable(plan: dict, renames: dict) -> dict:
    """A plan's dict with the module names mapped by ``renames`` and the
    job spec parsed."""
    def rename(cmd):
        return [renames.get(a, a) for a in cmd] if cmd else cmd

    for proc in plan.get("processes", []):
        proc["command"] = rename(proc["command"])
        if ENV_SPEC in proc.get("env", {}):
            proc["env"][ENV_SPEC] = json.loads(proc["env"][ENV_SPEC])
    for sidecar in plan.get("sidecars", []):
        sidecar["command"] = rename(sidecar.get("command"))
    return plan


def compile_spec(pf, pkg_reader, comp, spec, preset, **compile_kwargs):
    def run():
        op = pf.check_polyaxonfile(spec_source(spec),
                                   presets=preset_list(preset))
        resolved = pf.resolve_operation_context(
            op, params=trial_params(pkg_reader, op), run_uuid="uuid-1",
            run_name="run", project_name="proj")
        return comp.compile_operation(
            resolved, run_uuid="uuid-1", artifacts_root="/artifacts",
            project="proj", store_dir="/store", **compile_kwargs).to_dict()
    return outcome(run)


def both(spec, preset=None, *, plane=False):
    """(port's outcome, JAX's outcome with the port's module names); with
    ``plane``, each package compiles with CATALOG and a hub that holds
    BUILDER, as a control plane would hand them."""
    kwargs = {}
    if plane:
        kwargs = {"t": dict(catalog=tconn.ConnectionCatalog(CATALOG),
                            hub_resolver=lambda name: TComponent.from_dict(
                                BUILDER)),
                  "j": dict(catalog=jconn.ConnectionCatalog(CATALOG),
                            hub_resolver=lambda name: JComponent.from_dict(
                                BUILDER))}
    got = compile_spec(tpf, treader, tcomp, spec, preset,
                       **kwargs.get("t", {}))
    want = compile_spec(jpf, jreader, jcomp, spec, preset,
                        **kwargs.get("j", {}))
    if got[0] == "ok":
        got = ("ok", comparable(got[1], {}))
    if want[0] == "ok":
        want = ("ok", comparable(want[1], RENAMES))
    return got, want


@pytest.fixture(autouse=True)
def _no_catalog_env(monkeypatch):
    monkeypatch.delenv(jconn.catalog.ENV_CONNECTIONS, raising=False)
    monkeypatch.chdir(REPO)


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p and
                         os.path.basename(p).split(".")[0] or "none")
@pytest.mark.parametrize("spec", SPECS)
def test_plan_matches_jax(spec, preset):
    got, want = both(spec, preset)
    assert got == want


@pytest.mark.parametrize("spec", ["examples/build_then_train.yaml",
                                  "examples/scheduled_retrain.yaml"])
def test_plan_with_catalog_and_hub_matches_jax(spec):
    """The two examples the plain compile refuses (no hub; a dangling
    connection) compile alike once the plane's catalog and hub exist."""
    got, want = both(spec, plane=True)
    assert got == want and got[0] == "ok"
    if "build" in spec:
        build = got[1]["init"][0]
        assert build["kind"] == "build"
        assert build["config"]["destination"] == "registry.local/trainer:v1"
        assert {p["image"] for p in got[1]["processes"]} == {
            "registry.local/trainer:v1"}


def test_refusals_are_the_jax_packages():
    """A build section with no hub, a dangling connection and a spec of no
    operation kind are refused, by both packages alike."""
    for spec, cls, text in (
            ("examples/build_then_train.yaml", "CompilerError",
             "no component hub"),
            ("examples/scheduled_retrain.yaml", "CompilerError",
             "unknown connection `alerts`"),
            ("examples/deploy.yaml", "PolyaxonfileError",
             "Cannot determine spec kind")):
        got, want = both(spec)
        assert got == want and got[:2] == ("raises", cls), spec
        assert text in got[2]


INLINE = {
    "capture_profile_container": {
        "kind": "operation", "name": "prof",
        "plugins": {"captureProfile": True},
        "component": {"run": {"kind": "jaxjob", "container": {
            "image": "trainer", "command": ["python", "train.py"]}}}},
    "capture_profile_runtime": {
        "kind": "operation", "name": "prof",
        "plugins": {"captureProfile": {"steps": [1, 2]}},
        "component": {"run": {"kind": "jaxjob", "runtime": {
            "model": "llama_tiny", "steps": 4}}}},
    "capture_profile_short": {
        "kind": "operation", "name": "prof",
        "plugins": {"captureProfile": True},
        "component": {"run": {"kind": "jaxjob", "runtime": {
            "model": "llama_tiny", "steps": 2}}}},
    "dag": {
        "kind": "operation", "name": "pipeline",
        "component": {"run": {"kind": "dag", "operations": [
            {"name": "a", "component": {"run": {
                "kind": "job", "container": {"image": "x"}}}}]}}},
    "watchdog": {
        "kind": "operation", "name": "wd",
        "component": {"run": {"kind": "watchdog", "intervalSeconds": 30,
                              "container": {"image": "x",
                                            "command": ["true"]}}}},
    "git_init_from_catalog": {
        "kind": "operation", "name": "git",
        "component": {"run": {"kind": "job",
                              "init": [{"git": {"revision": "main"},
                                        "connection": "repo"},
                                       {"connection": "store",
                                        "artifacts": {"dirs": ["d"]}}],
                              "container": {"image": "x",
                                            "command": ["ls"]}}}},
    "notifier_not_a_notifier": {
        "kind": "operation", "name": "n",
        "notifications": [{"connections": ["store"], "trigger": "done"}],
        "component": {"run": {"kind": "job", "container": {"image": "x"}}}},
}


@pytest.mark.parametrize("name", sorted(INLINE))
def test_inline_specs_match_jax(name):
    """Cases no shipped file reaches: captureProfile on a container jaxjob
    (refused) and on the builtin runtime, a DAG (not compilable to one
    plan), the watchdog's watchloop, connections that inject env, and a
    store named as a notifier (refused)."""
    spec = INLINE[name]

    def run(pf, comp, catalog):
        op = pf.check_polyaxonfile(spec)
        resolved = pf.resolve_operation_context(op, run_uuid="u")
        return comp.compile_operation(
            resolved, run_uuid="u", artifacts_root="/a",
            catalog=catalog).to_dict()

    got = outcome(lambda: run(tpf, tcomp, tconn.ConnectionCatalog(CATALOG)))
    want = outcome(lambda: run(jpf, jcomp, jconn.ConnectionCatalog(CATALOG)))
    if got[0] == "ok":
        got = ("ok", comparable(got[1], {}))
    if want[0] == "ok":
        want = ("ok", comparable(want[1], RENAMES))
    assert got == want
    if name == "watchdog":
        assert got[1]["processes"][0]["command"][:3] == [
            "python", "-m", "polyaxon_tpu_torch.utils.watchloop"]
    if name in ("capture_profile_container", "dag",
                "notifier_not_a_notifier"):
        assert got[0] == "raises"


def test_packed_pretrain_plan():
    """The plan the H100 smoke test runs: one process, the port's
    launcher, the runtime and checkpointing of the example with the
    presets' changes."""
    h100 = {"isPreset": True, "patchStrategy": "post_merge",
            "runPatch": {"numProcesses": 1, "runtime": {
                "steps": 6, "grad_accum_steps": 4}}}
    presets = [os.path.join(REPO, "tests/fixtures/presets/gpu.yaml"), h100]
    plans = {}
    for key, pf, comp in (("t", tpf, tcomp), ("j", jpf, jcomp)):
        op = pf.check_polyaxonfile(
            [os.path.join(REPO, "examples/packed_pretrain.yaml")],
            params={"corpus": "/data/c.txt"}, presets=presets)
        resolved = pf.resolve_operation_context(op, run_uuid="u")
        plans[key] = comp.compile_operation(resolved, run_uuid="u",
                                            artifacts_root="/a")
    plan = plans["t"]
    assert comparable(plan.to_dict(), {}) == comparable(
        plans["j"].to_dict(), RENAMES)
    assert plan.num_processes == 1
    proc = plan.processes[0]
    assert proc.command[1:] == ["-m", "polyaxon_tpu_torch.runtime.launch"]
    job = json.loads(proc.env[ENV_SPEC])
    assert job["runtime"] == {
        "model": "llama3_1b", "dataset": "lm_text_packed",
        "path": "/data/c.txt", "tokenizer": "bytes", "steps": 6,
        "seq_len": 4096, "global_batch_size": 16, "learning_rate": 3e-4,
        "lr_schedule": "cosine", "remat": "dots", "attention_impl": "flash",
        "grad_accum_steps": 4}
    assert job["checkpointing"] == {"enabled": True, "intervalSteps": 500,
                                    "maxToKeep": 3, "asyncSave": True,
                                    "restoreOnStart": True}
    assert proc.env[tcompile.ENV_NUM_PROCESSES] == "1"
    assert [p.kind for p in plan.init] == ["auth"]


def test_bootstrap_env_names_are_the_jax_packages():
    assert (tcompile.ENV_COORDINATOR, tcompile.ENV_NUM_PROCESSES,
            tcompile.ENV_PROCESS_ID, tcompile.ENV_LOCAL_DEVICE_IDS) == (
        jboot.ENV_COORDINATOR, jboot.ENV_NUM_PROCESSES, jboot.ENV_PROCESS_ID,
        jboot.ENV_LOCAL_DEVICE_IDS)
    assert tcomp.ENV_JAXJOB_SPEC == jcomp.ENV_JAXJOB_SPEC
    assert tcomp.COORDINATOR_PLACEHOLDER == jcomp.COORDINATOR_PLACEHOLDER


@pytest.mark.parametrize("entries", [
    [{"name": "a", "kind": "teleport"}],
    [{"name": "a", "kind": "slack"}, {"name": "a", "kind": "git"}],
    [{"name": "a", "kind": "s3", "schema": {"bucket": "s3://b"}}],
])
def test_catalog_matches_jax(entries):
    def run(conn):
        cat = conn.ConnectionCatalog(entries)
        return cat.to_dict(), cat.env_for(cat.names()), [
            c.store_url() for c in cat.resolve_all(cat.names())]

    got, want = outcome(lambda: run(tconn)), outcome(lambda: run(jconn))
    assert got == want
