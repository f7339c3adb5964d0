"""The slice end to end on the CPU: Polyaxonfile → the port's compiled
launch plan → the port's launcher, against the JAX package.

- ``LLAMA_PRETRAIN`` (``tests/test_acceptance.py``), copied with the mesh
  at one device, ``attention_impl: xla`` named (the port's kernels do not
  take llama_tiny's head_dim 16), f32 and a loss emitted every step, is
  compiled by each package. The port's plan runs through
  ``launch.main(device="cpu")`` with its process's env; the JAX package's
  through ``run_jaxjob``, from the same initial weights (JAX's, through
  ``params_from_numpy``) and batches. The losses agree to 1e-4, the
  tolerance ``tests/test_torch_checkpoint.py`` holds ``run_torchjob`` to
  against ``run_jaxjob``. The JAX package's ``StreamsService`` reads the
  port run's directory as ``tests/test_acceptance.py`` reads a run of its
  own: loss events, ``outputs["steps"] == 4`` and a checkpoints artifact.
- ``examples/packed_pretrain.yaml`` at llama_tiny scale on a seeded text
  corpus, the same way.
- ``lm_file``, ``lm_text`` and ``lm_text_packed`` give batches bitwise
  equal to the JAX package's, from ``start_batch`` 0 and 3, whichever
  package wrote the token cache; their refusals are the JAX package's.
- A held-out ``eval_path`` is evaluated as the JAX package evaluates it.
- A plan of two processes without its coordinator address fails in the
  launcher before it trains.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from polyaxon_tpu.runtime import data as jdata
from polyaxon_tpu.streams.service import StreamsService
from polyaxon_tpu_torch import compiler as tcomp
from polyaxon_tpu_torch import polyaxonfile as tpf
from polyaxon_tpu_torch.runtime import data as tdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ABS_TOL = 1e-4
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def llama_pretrain_copy() -> dict:
    from tests.test_acceptance import LLAMA_PRETRAIN

    spec = yaml.safe_load(LLAMA_PRETRAIN)
    run = spec["component"]["run"]
    run["mesh"] = {"axes": {"dp": 1}}
    run["runtime"].update(attention_impl="xla", dtype="float32", log_every=1)
    return spec


def corpus(path, n_docs: int = 64, seed: int = SEED) -> str:
    """Documents of random lowercase words, separated by blank lines."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    docs = []
    for _ in range(n_docs):
        words = ["".join(rng.choice(letters, rng.integers(1, 9)))
                 for _ in range(rng.integers(5, 60))]
        docs.append(" ".join(words))
    with open(path, "w") as fh:
        fh.write("\n\n".join(docs) + "\n")
    return str(path)


def compile_both(spec, artifacts_root, **check_kwargs):
    """The port's and the JAX package's plans of one spec."""
    from polyaxon_tpu import compiler as jcomp
    from polyaxon_tpu import polyaxonfile as jpf

    plans = []
    for pf, comp, root in ((tpf, tcomp, "torch"), (jpf, jcomp, "jax")):
        op = pf.check_polyaxonfile(copy.deepcopy(spec), **check_kwargs)
        resolved = pf.resolve_operation_context(op, run_uuid="run-1")
        plans.append((resolved, comp.compile_operation(
            resolved, run_uuid="run-1",
            artifacts_root=os.path.join(artifacts_root, root))))
    return plans


def jax_initial_params(runtime: dict):
    """JAX's initial weights for a runtime section, as numpy."""
    import jax

    from polyaxon_tpu.models import get_model as jget_model
    from polyaxon_tpu.models import llama as jllama
    from polyaxon_tpu.parallel import build_mesh, rules_for_mesh
    from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
    from polyaxon_tpu.runtime.optim import build_optimizer as jbuild
    from polyaxon_tpu.runtime.step import build_init as jinit

    jcfg = JCfg.model_validate(runtime)
    model = jget_model(jcfg.model,
                       **jcfg.model_overrides(jllama.LlamaConfig))
    mesh = build_mesh(axes={"dp": 1}, devices=jax.devices()[:1])
    with mesh:
        st = jinit(model, jbuild(jcfg), mesh, rules_for_mesh(mesh))(
            jax.random.key(jcfg.seed))
        return jax.tree.map(np.asarray, st["params"])


def start_from(monkeypatch, params0):
    """The port's loop starts from ``params0`` (numpy, JAX's names)."""
    from polyaxon_tpu_torch.models import llama as tllama
    from polyaxon_tpu_torch.runtime import loop, step

    def build_init(model_def, optimizer, *, device, **kwargs):
        params = tllama.params_from_numpy(model_def.config, params0,
                                          device=device)
        return step.build_init(model_def, optimizer, device=device,
                               params=params, **kwargs)

    monkeypatch.setattr(loop, "build_init", build_init)


def launch_plan(plan, monkeypatch, capsys):
    """Run the plan's one process as the executor starts it: its env over
    this process's, the coordinator placeholder at 127.0.0.1, through
    ``launch.main(device="cpu")``. Returns (exit code, JSON lines)."""
    from polyaxon_tpu_torch.runtime import launch

    assert plan.num_processes == 1
    proc = plan.processes[0]
    assert proc.command[1:] == ["-m", "polyaxon_tpu_torch.runtime.launch"]
    for key, value in proc.env.items():
        monkeypatch.setenv(key, value.replace(tcomp.COORDINATOR_PLACEHOLDER,
                                              "127.0.0.1"))
    capsys.readouterr()
    rc = launch.main(device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    return rc, lines


def run_jax(resolved, plan, **kwargs):
    import jax

    from polyaxon_tpu.runtime.loop import run_jaxjob

    seen = {}
    result = run_jaxjob(resolved.component.run,
                        artifacts_dir=plan.artifacts_dir,
                        devices=jax.devices()[:1],
                        on_metrics=lambda s, v: seen.setdefault(s, {})
                        .update(v), **kwargs)
    return result, {s: v["loss"] for s, v in seen.items() if "loss" in v}


def hold_against_jax(port_lines, jax_losses, jax_result):
    port_losses = {x["step"]: x["loss"] for x in port_lines if "loss" in x}
    assert sorted(port_losses) == sorted(jax_losses)
    for step, loss in jax_losses.items():
        assert port_losses[step] == pytest.approx(loss, abs=LOSS_ABS_TOL), step
    outputs = port_lines[-2]["outputs"]
    assert set(port_lines[-1]) == {"launches"}
    assert outputs["steps"] == jax_result.steps
    assert outputs["final_metrics"]["loss"] == pytest.approx(
        jax_result.final_metrics["loss"], abs=LOSS_ABS_TOL)
    return port_losses


def test_llama_pretrain_through_the_port_matches_jax(tmp_path, monkeypatch,
                                                     capsys):
    spec = llama_pretrain_copy()
    (tres, tplan), (jres, jplan) = compile_both(spec, str(tmp_path))
    runtime = json.loads(tplan.processes[0].env[tcomp.ENV_JAXJOB_SPEC])[
        "runtime"]
    assert runtime["learning_rate"] == 0.001  # the rendered param
    start_from(monkeypatch, jax_initial_params(runtime))
    rc, lines = launch_plan(tplan, monkeypatch, capsys)
    assert rc == 0
    jresult, jlosses = run_jax(jres, jplan)
    losses = hold_against_jax(lines, jlosses, jresult)
    assert sorted(losses) == [1, 2, 3]

    # The assertions of tests/test_acceptance.py, on the port's run.
    streams = StreamsService(os.path.join(str(tmp_path), "torch"))
    metrics = streams.get_metrics("run-1", ["loss"])
    assert [r["value"] for r in metrics["loss"]] == [losses[s] for s in
                                                     (1, 2, 3)]
    assert streams.get_outputs("run-1")["steps"] == 4
    assert any("checkpoints" in a for a in streams.list_artifacts("run-1"))
    assert [s["status"] for s in streams.get_statuses("run-1")] == [
        "running", "succeeded"]


PACKED_CPU = {"isPreset": True, "patchStrategy": "post_merge",
              "runPatch": {"numProcesses": 1,
                           "checkpointing": {"intervalSteps": 2},
                           "runtime": {"model": "llama_tiny", "steps": 4,
                                       "seq_len": 64, "global_batch_size": 4,
                                       "grad_accum_steps": 2,
                                       "attention_impl": "xla",
                                       "dtype": "float32", "log_every": 1,
                                       "remat": "none"}}}


def test_packed_pretrain_example_through_the_port_matches_jax(
        tmp_path, monkeypatch, capsys):
    """examples/packed_pretrain.yaml as the H100 smoke test compiles it
    (the gpu preset, one process), cut to llama_tiny on a small corpus;
    the JAX run takes one device for the example's 2x4 topology."""
    path = corpus(tmp_path / "corpus.txt")
    presets = [os.path.join(REPO, "tests/fixtures/presets/gpu.yaml"),
               PACKED_CPU]
    with open(os.path.join(REPO, "examples/packed_pretrain.yaml")) as fh:
        spec = yaml.safe_load(fh)
    (tres, tplan), (jres, jplan) = compile_both(
        spec, str(tmp_path), params={"corpus": path}, presets=presets)
    runtime = json.loads(tplan.processes[0].env[tcomp.ENV_JAXJOB_SPEC])[
        "runtime"]
    assert (runtime["dataset"], runtime["path"], runtime["tokenizer"]) == (
        "lm_text_packed", path, "bytes")
    start_from(monkeypatch, jax_initial_params(runtime))
    rc, lines = launch_plan(tplan, monkeypatch, capsys)
    assert rc == 0
    jresult, jlosses = run_jax(jres, jplan, mesh_axes={"fsdp": 1})
    assert sorted(hold_against_jax(lines, jlosses, jresult)) == [1, 2, 3]
    ckdir = os.path.join(tplan.artifacts_dir, "checkpoints")
    assert sorted(n for n in os.listdir(ckdir) if n.isdigit()) == ["2", "4"]


def test_eval_path_matches_jax(tmp_path, monkeypatch):
    """``lm_text`` with a held-out ``eval_path``: the port's eval losses
    are the JAX package's, and differ from those of the training corpus
    (the eval reads the other file)."""
    from polyaxon_tpu.polyflow.runs import V1JAXJob
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    train = corpus(tmp_path / "train.txt")
    held_out = corpus(tmp_path / "eval.txt", seed=SEED + 1)
    runtime = dict(model="llama_tiny", dataset="lm_text", path=train,
                   tokenizer="bytes", eval_path=held_out, eval_every=2,
                   eval_steps=2, steps=3, seq_len=32, global_batch_size=4,
                   log_every=1, attention_impl="xla", dtype="float32")
    start_from(monkeypatch, jax_initial_params(runtime))
    evals = {}
    for key, path in (("held_out", held_out), ("train", train)):
        job = {"kind": "jaxjob", "mesh": {"axes": {"dp": 1}},
               "runtime": dict(runtime, eval_path=path)}
        evals[key] = run_torchjob(job, device="cpu").final_metrics[
            "eval_loss"]
    import jax

    from polyaxon_tpu.runtime.loop import run_jaxjob

    want = run_jaxjob(V1JAXJob.from_dict(
        {"kind": "jaxjob", "mesh": {"axes": {"dp": 1}}, "runtime": runtime}),
        devices=jax.devices()[:1]).final_metrics["eval_loss"]
    assert evals["held_out"] == pytest.approx(want, abs=LOSS_ABS_TOL)
    assert abs(evals["held_out"] - evals["train"]) > 10 * LOSS_ABS_TOL


def test_launcher_refuses_a_multi_process_plan(tmp_path, monkeypatch,
                                               capsys):
    """The example's 2x4 topology compiles to two processes. The port's
    launcher starts the gang's process group from the plan's env
    contract, and refuses a plan whose coordinator address is missing as
    the JAX package's bootstrap refuses it, before training (gangs that
    train: ``tests/test_torch_gang.py``)."""
    from polyaxon_tpu_torch.runtime import launch

    op = tpf.check_polyaxonfile(
        os.path.join(REPO, "examples/packed_pretrain.yaml"),
        params={"corpus": corpus(tmp_path / "corpus.txt")})
    plan = tcomp.compile_operation(
        tpf.resolve_operation_context(op, run_uuid="two"), run_uuid="two",
        artifacts_root=str(tmp_path / "runs"))
    assert plan.num_processes == 2
    for key, value in plan.processes[0].env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("POLYAXON_TPU_COORDINATOR")
    assert launch.main(device="cpu") == 1
    assert "POLYAXON_TPU_COORDINATOR is unset" in capsys.readouterr().err
    statuses = StreamsService(str(tmp_path / "runs")).get_statuses("two")
    assert [s["status"] for s in statuses] == ["running", "failed"]
    assert "POLYAXON_TPU_COORDINATOR is unset" in statuses[-1]["message"]
    assert statuses[-1]["reason"] == "RuntimeError"
    assert not os.path.exists(os.path.join(plan.artifacts_dir,
                                           "checkpoints"))
    monkeypatch.setenv("POLYAXON_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("POLYAXON_JAXJOB_SPEC", "{}")
    assert launch.main(device="cpu") == 1  # past the check: no runtime
    assert "is unset" not in capsys.readouterr().err


# ----------------------------------------------------------------- data
def token_file(path) -> str:
    rng = np.random.default_rng(SEED)
    np.save(path, rng.integers(0, 256, size=5000).astype(np.int32))
    return str(path)


DATASETS = {
    "lm_file": lambda d: dict(path=token_file(d / "tokens.npy")),
    "lm_text": lambda d: dict(path=corpus(d / "corpus.txt"),
                              tokenizer="bytes", vocab_size=256),
    "lm_text_packed": lambda d: dict(path=corpus(d / "corpus.txt"),
                                     tokenizer="bytes", vocab_size=256),
}


def take(module, name, kwargs, start_batch, n=3):
    it = module.get_dataset(name, batch_size=4, seq_len=48, seed=7,
                            start_batch=start_batch, **kwargs)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("first", ["torch", "jax"])
@pytest.mark.parametrize("start_batch", [0, 3])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_text_datasets_match_jax_bitwise(name, start_batch, first, tmp_path):
    """Batches equal bitwise, dtype included, with the token cache written
    by ``first`` and read by the other package."""
    kwargs = DATASETS[name](tmp_path)
    order = (tdata, jdata) if first == "torch" else (jdata, tdata)
    batches = {mod: take(mod, name, kwargs, start_batch) for mod in order}
    if name != "lm_file":
        caches = sorted(n for n in os.listdir(tmp_path) if ".bytes." in n)
        assert caches, "no token cache beside the corpus"
    for got, want in zip(batches[tdata], batches[jdata]):
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert np.array_equal(got[key], want[key]), key
    if name == "lm_text_packed":
        assert batches[tdata][0]["segments"].max() > 0


@pytest.mark.parametrize("name,kwargs", [
    ("lm_file", {}),
    ("lm_text", {"tokenizer": "bytes", "vocab_size": 100}),
    ("lm_text_packed", {"tokenizer": "bytes", "vocab_size": 100}),
    ("lm_text_packed", {"tokenizer": "bytes", "seq_len": 100_000}),
    ("lm_text", {"tokenizer": "bytes", "seq_len": 100_000}),
])
def test_text_dataset_refusals_match_jax(name, kwargs, tmp_path):
    """A missing path, a tokenizer beyond the model's vocab, a corpus
    shorter than one row: the JAX package's exception and message."""
    if name != "lm_file":
        kwargs = dict(kwargs, path=corpus(tmp_path / "c.txt", n_docs=4))
    kwargs.setdefault("seq_len", 48)

    def outcome(mod):
        try:
            next(mod.get_dataset(name, batch_size=2, **kwargs))
        except ValueError as exc:
            return type(exc).__name__, str(exc)
        return None

    assert outcome(tdata) == outcome(jdata) is not None
