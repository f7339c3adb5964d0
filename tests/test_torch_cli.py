"""The port's CLI (``python -m polyaxon_tpu_torch.cli``, ``plx-torch``)
against the JAX package's ``plx``, on the CPU.

- Both command trees hold the same commands, and each command the same
  options (names, flags, types, defaults, choices), one case per
  command; ``run``, ``server``, ``agent`` and ``serve`` add ``--device``
  (the port's stand-in for ``JAX_PLATFORMS=cpu``).
- ``check``, ``run`` (``-w``: mnist_cnn on the CPU, ``--device cpu`` for
  the port; a grid sweep of two script trials), ``ops ls/get/statuses/
  compare/trials/lineage``, ``projects``, ``queue``, ``quota``,
  ``models`` and ``version`` print the same through both CLIs, each in a
  home of its own.
- ``convert --from-hf`` of a seeded llama_tiny safetensors file writes
  the port's checkpoint, whose params equal the JAX package's
  ``from_hf_llama`` (f32, relative 1e-6); ``convert --from-orbax`` of it
  gives the input tensors back exactly.
- ``serve --device cpu`` (a subprocess) serves that checkpoint: one
  greedy request's tokens equal the JAX package's ``ServingServer`` over
  the same weights (its Orbax checkpoint written by ``plx convert``).

Normalisation: run uuids are replaced by ``<run-N>`` in the order they
first appear, ISO times by ``<time>``, the homes by ``<home>``, and
decimal numbers by ``<num>`` (losses, throughputs and times, which the
two trainers reach from their own initial weights and clocks; integer
counts such as steps and params stay), and runs of spaces by one (the
tables pad each column to its widest number).
"""

import json
import os
import re
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
from click.testing import CliRunner

from tests.torch_deadline import deadline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mnist.yaml")
DEVICE_COMMANDS = {"run", "server", "agent", "serve"}


def _clis():
    from polyaxon_tpu.cli.main import cli as jcli
    from polyaxon_tpu_torch.cli.main import cli as tcli

    return {"jax": jcli, "torch": tcli}


def _walk(group, prefix=()):
    out = {}
    for name, cmd in sorted(group.commands.items()):
        path = prefix + (name,)
        out[" ".join(path)] = cmd
        if hasattr(cmd, "commands"):
            out.update(_walk(cmd, path))
    return out


def _option(param) -> tuple:
    choices = getattr(param.type, "choices", None)
    return (param.name, tuple(param.opts), tuple(param.secondary_opts),
            param.type.name, param.multiple, getattr(param, "is_flag", None),
            repr(param.default), param.required, param.nargs,
            tuple(choices) if choices else None,
            getattr(param, "hidden", False), getattr(param, "envvar", None))


def _command_paths():
    from polyaxon_tpu.cli.main import cli

    return sorted(_walk(cli))


@pytest.mark.parametrize("path", _command_paths())
def test_command_tree(path):
    trees = {pkg: _walk(cli) for pkg, cli in _clis().items()}
    assert sorted(trees["torch"]) == sorted(trees["jax"])
    opts = {pkg: [_option(p) for p in trees[pkg][path].params]
            for pkg in trees}
    if path in DEVICE_COMMANDS:
        device = [o for o in opts["torch"] if o[0] == "device"]
        assert device and device[0][1] == ("--device",)
        assert device[0][6] == "None"  # the card unless the user names one
        opts["torch"] = [o for o in opts["torch"] if o[0] != "device"]
    assert opts["torch"] == opts["jax"]


TRIAL = {
    "kind": "component",
    "inputs": [{"name": "lr", "type": "float", "toEnv": "LR"}],
    "run": {"kind": "job", "container": {"command": [
        sys.executable, "-c",
        "import json, os\n"
        "d = os.environ['POLYAXON_RUN_ARTIFACTS_PATH']\n"
        "os.makedirs(d + '/events/metric', exist_ok=True)\n"
        "score = (float(os.environ['LR']) - 0.3) ** 2\n"
        "with open(d + '/events/metric/score.jsonl', 'a') as fh:\n"
        "    fh.write(json.dumps({'step': 1, 'value': score}) + '\\n')\n"]}},
}
SWEEP = {"kind": "operation", "name": "grid",
         "matrix": {"kind": "grid", "params": {
             "lr": {"kind": "choice", "value": [0.1, 0.5]}}},
         "component": TRIAL}


class Session:
    """One CLI over its own home; every output normalised."""

    def __init__(self, cli, home, monkeypatch):
        self.cli, self.home, self.monkeypatch = cli, home, monkeypatch
        self.runner, self.ids = CliRunner(), {}

    def __call__(self, *args):
        self.monkeypatch.setenv("POLYAXON_TPU_HOME", self.home)
        result = self.runner.invoke(self.cli, [str(a) for a in args])
        return result.exit_code, result.output

    def uid(self, output: str) -> str:
        return output.split("Run created: ")[1].split()[0]

    def norm(self, value):
        if isinstance(value, (list, tuple)):
            return [self.norm(v) for v in value]
        if isinstance(value, float):
            return "<num>"
        if not isinstance(value, str):
            return value
        text = value
        for uuid in re.findall(r"(?<![\d.])\b[0-9a-f]{12}\b(?![\d.])", text):
            self.ids.setdefault(uuid, f"<run-{len(self.ids)}>")
        for uuid, label in self.ids.items():
            text = text.replace(uuid, label).replace(uuid[:12], label)
        text = re.sub(r"\d{4}-\d\d-\d\dT[\d:.]+(\+00:00)?", "<time>", text)
        text = text.replace(self.home, "<home>")
        text = re.sub(r"-?\d+\.\d*(e[-+]?\d+)?|-?\d+e[-+]?\d+", "<num>",
                      text)
        return re.sub(r" +", " ", text)


def _script(s: Session, pkg: str, tmp_path) -> dict:
    """The command sequence; each entry is (exit code, output)."""
    out = {}
    device = ["--device", "cpu"] if pkg == "torch" else []
    out["check"] = s("check", "-f", FIXTURE, "-P", "lr=0.05")
    out["check_bad_param"] = s("check", "-f", FIXTURE, "-P", "bogus=1")
    out["check_missing"] = s("check", "-f", "nope.yaml")
    code, text = s("run", "-f", FIXTURE, "-p", "demo", "-w", *device)
    trained = s.uid(text)
    # The status lines the -w loop prints depend on its poll timing;
    # the last one and the outputs are compared.
    lines = text.splitlines()
    at = next(i for i, l in enumerate(lines) if l.startswith("outputs:"))
    outputs = json.loads("\n".join(lines[at:])[len("outputs:"):])
    out["run_watch"] = (code, lines[:2], [l for l in lines
                                          if "status:" in l][-1],
                        sorted(outputs.items()))
    sweep_file = tmp_path / f"sweep-{pkg}.json"
    sweep_file.write_text(json.dumps(SWEEP))
    code, text = s("run", "-f", sweep_file, "-w", *device)
    sweep = s.uid(text)
    out["sweep_status"] = (code, [l for l in text.splitlines()
                                  if "status:" in l][-1])
    # Submitted after every -w loop has ended: no agent runs it.
    out["run_created"] = s("run", "-f", FIXTURE, "-p", "demo", "-P",
                           "lr=0.01", "--name", "second")
    second = s.uid(out["run_created"][1])
    out["ops_ls"] = s("ops", "ls", "-p", "demo")
    out["ops_ls_status"] = s("ops", "ls", "--status", "succeeded")
    out["ops_get"] = s("ops", "get", "-uid", trained)
    out["ops_get_unknown"] = s("ops", "get", "-uid", "nope")
    out["ops_statuses"] = s("ops", "statuses", "-uid", second)
    out["ops_compare"] = s("ops", "compare", trained, second)
    out["ops_compare_one"] = s("ops", "compare", trained)
    out["ops_trials"] = s("ops", "trials", "-uid", sweep)
    out["ops_trials_empty"] = s("ops", "trials", "-uid", second)
    out["ops_lineage"] = s("ops", "lineage", "-uid", trained)
    out["ops_lineage_graph"] = s("ops", "lineage", "-uid", trained,
                                 "--graph")
    out["ops_metrics"] = s("ops", "metrics", "-uid", trained)
    out["projects_create"] = s("projects", "create", "--name", "p1",
                               "--description", "first")
    out["projects_ls"] = s("projects", "ls")
    out["queue_add"] = s("queue", "add", "batch", "--priority", "3",
                         "--concurrency", "2", "--preemptible")
    out["queue_ls"] = s("queue", "ls")
    out["queue_inspect"] = s("queue", "inspect", "batch")
    out["queue_rm"] = s("queue", "rm", "batch")
    out["queue_rm_missing"] = s("queue", "rm", "batch")
    out["quota_set"] = s("quota", "set", "demo", "--max-runs", "3",
                         "--max-chips", "8", "--weight", "2")
    out["quota_ls"] = s("quota", "ls")
    out["quota_rm"] = s("quota", "rm", "demo")
    out["quota_rm_missing"] = s("quota", "rm", "demo")
    out["models"] = s("models")
    out["version"] = s("version")
    return {k: json.dumps(s.norm(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("cli")
    try:
        return {pkg: _script(Session(cli, str(tmp / pkg), mp), pkg, tmp)
                for pkg, cli in _clis().items()}
    finally:
        mp.undo()


COMMANDS = ["check", "check_bad_param", "check_missing", "run_watch",
            "run_created", "sweep_status", "ops_ls", "ops_ls_status",
            "ops_get", "ops_get_unknown", "ops_statuses", "ops_compare",
            "ops_compare_one", "ops_trials", "ops_trials_empty",
            "ops_lineage", "ops_lineage_graph", "ops_metrics",
            "projects_create", "projects_ls", "queue_add", "queue_ls",
            "queue_inspect", "queue_rm", "queue_rm_missing", "quota_set",
            "quota_ls", "quota_rm", "quota_rm_missing", "models", "version"]


@pytest.mark.parametrize("name", COMMANDS)
def test_outputs_equal(name, outputs):
    assert outputs["torch"][name] == outputs["jax"][name]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A seeded llama_tiny HF file and the port's conversion of it."""
    import torch
    from safetensors.torch import save_file

    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.models.convert import to_hf_llama

    tmp = tmp_path_factory.mktemp("convert")
    cfg = llama.CONFIGS["llama_tiny"]
    gen = torch.Generator().manual_seed(7)
    params = llama.init(cfg, gen, device="cpu")["params"]
    rng = np.random.default_rng(7)
    state = {k: torch.from_numpy(rng.standard_normal(v.shape, np.float32)
                                 * 0.05)
             for k, v in to_hf_llama(params, cfg).items()}
    src = str(tmp / "model.safetensors")
    save_file(state, src)
    from polyaxon_tpu_torch.cli.main import cli

    out = str(tmp / "ckpt")
    result = CliRunner().invoke(cli, ["convert", "--model", "llama_tiny",
                                      "--from-hf", src, "--out", out])
    assert result.exit_code == 0, result.output
    return src, out, state, result.output


def test_convert_from_hf_matches_reference(converted):
    from safetensors.numpy import load_file

    from polyaxon_tpu.models import llama as jllama
    from polyaxon_tpu.models.convert import from_hf_llama
    from polyaxon_tpu_torch.runtime.checkpoint import flatten, load_tree

    src, out, _, printed = converted
    step, tree = load_tree(out, only="params")
    want = from_hf_llama(load_file(src), jllama.CONFIGS["llama_tiny"])
    flat = {k: np.asarray(v) for k, v in flatten(want["params"])}
    got = {k: v.numpy() for k, v in flatten(tree["params"])}
    assert step == 0 and sorted(got) == sorted(flat)
    for key, ref in flat.items():
        assert got[key].dtype == np.float32 and got[key].shape == ref.shape
        err = np.abs(got[key] - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 1e-6, key
    n = sum(v.size for v in flat.values())
    assert printed == f"converted llama_tiny: {n:,} params → {out}\n"


def test_convert_from_orbax_exports_input(converted, tmp_path):
    from safetensors.torch import load_file

    from polyaxon_tpu_torch.cli.main import cli

    _, out, state, _ = converted
    dest = str(tmp_path / "hf")
    result = CliRunner().invoke(cli, ["convert", "--model", "llama_tiny",
                                      "--from-orbax", out, "--out", dest])
    assert result.exit_code == 0, result.output
    back = load_file(os.path.join(dest, "model.safetensors"))
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch_equal(back[key], value), key
    from polyaxon_tpu_torch.models import llama

    with open(os.path.join(dest, "config.json")) as fh:
        config = json.load(fh)
    cfg = llama.CONFIGS["llama_tiny"]
    assert (config["num_hidden_layers"], config["hidden_size"]) == (
        cfg.n_layers, cfg.dim)
    again = CliRunner().invoke(cli, ["convert", "--model", "llama_tiny",
                                     "--from-orbax", out, "--out", dest])
    assert again.exit_code != 0 and "already contains" in again.output


def torch_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())


@deadline(180)
def test_serve_matches_reference(converted, tmp_path):
    """``serve --device cpu`` over the converted checkpoint answers one
    greedy request with the JAX ``ServingServer``'s tokens over the same
    weights."""
    from polyaxon_tpu.cli.main import cli as jcli
    from polyaxon_tpu.serving import ServingServer

    src, out, _, _ = converted
    orbax = str(tmp_path / "orbax")
    result = CliRunner().invoke(jcli, ["convert", "--model", "llama_tiny",
                                       "--from-hf", src, "--out", orbax])
    assert result.exit_code == 0, result.output
    request = {"tokens": [[3, 17, 42, 5, 9]], "max_new_tokens": 8}
    proc = subprocess.Popen(
        [sys.executable, "-m", "polyaxon_tpu_torch.cli", "serve", "--model",
         "llama_tiny", "--checkpoint", out, "--port", "0", "--device", "cpu"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        with ServingServer("llama_tiny", orbax, port=0) as server:
            want = _post(server.url, request)
        line = proc.stdout.readline()
        assert line.startswith("serving llama_tiny at http://"), line
        got = _post(line.split(" at ")[1].strip(), request)
    finally:
        proc.terminate()
        rc = proc.wait(timeout=60)
    assert got["tokens"] == want["tokens"]
    assert len(got["tokens"][0]) == 8
    assert rc == 0


def _post(url, body):
    req = urllib.request.Request(f"{url}/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())
