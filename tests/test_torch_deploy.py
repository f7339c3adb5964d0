"""The port's deploy layer (``polyaxon_tpu_torch/deploy``, ``proxies``)
against the JAX package's, on the CPU.

``check_deployment`` + ``render_deployment`` over ``tests/test_deploy.py``'s
values (and ``examples/deploy.yaml``) write the same files, byte for
byte; ``admin deploy`` (``--dry-run`` and not) and ``admin teardown``
print the same through both CLIs; invalid values are refused alike.

Normalisation: each package renders into a home of its own, so the home
path is replaced by ``<home>``; and the port's files name
``polyaxon_tpu_torch`` and ``plx-torch`` where the JAX package's name
``polyaxon_tpu`` and ``plx`` (the port's run.sh starts the port's
server), so those two names are replaced by the JAX package's.
"""

import copy
import json
import os

import pytest
import yaml
from click.testing import CliRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VALUES = {
    "deploymentType": "local",
    "api": {"host": "127.0.0.1", "port": 9000},
    "gateway": {"enabled": True, "port": 9443},
    "agent": {"enabled": True,
              "slices": [{"name": "pool0", "topology": "4x4"},
                         {"name": "spot0", "topology": "2x2",
                          "preemptible": True}]},
    "artifactsStore": "store",
    "connections": [
        {"name": "store", "kind": "host_path",
         "schema": {"hostPath": "/mnt/s"}},
    ],
}


def _variant(**changes):
    values = copy.deepcopy(VALUES)
    values.update(changes)
    return values


with open(os.path.join(REPO, "examples", "deploy.yaml")) as _fh:
    EXAMPLE = yaml.safe_load(_fh)

CONFIGS = {
    "values": VALUES,
    "agent_tuning": _variant(agent={"enabled": True, "maxConcurrent": 16,
                                    "heartbeatTimeout": 300}),
    "env_quoted": _variant(environment={"NASTY": "a b; echo pwned"}),
    "ssl": _variant(gateway={"enabled": True, "port": 8443, "ssl": {
        "cert": "/etc/ssl/c.pem", "key": "/etc/ssl/k.pem"}}),
    "no_agent_no_gateway": _variant(agent={"enabled": False},
                                    gateway={"enabled": False}),
    "gpu_host": _variant(agent={"enabled": True, "slices": [
        {"name": "gpu0", "topology": "4"}]}),
    "example": EXAMPLE,
}
INVALID = {
    "bad_type": {"deploymentType": "warp"},
    "unknown_store": _variant(artifactsStore="ghost"),
    "ssl_partial": _variant(gateway={"enabled": True,
                                     "ssl": {"cert": "/c.pem"}}),
    "duplicate_connection": _variant(connections=VALUES["connections"] * 2),
}


def _pkg(pkg):
    if pkg == "jax":
        from polyaxon_tpu.cli.main import cli
        from polyaxon_tpu.deploy import check_deployment, render_deployment
    else:
        from polyaxon_tpu_torch.cli.main import cli
        from polyaxon_tpu_torch.deploy import (check_deployment,
                                               render_deployment)
    return cli, check_deployment, render_deployment


def _norm(text: str, home: str) -> str:
    return (text.replace(home, "<home>")
            .replace("polyaxon_tpu_torch", "polyaxon_tpu")
            .replace("plx-torch", "plx"))


def _files(written: dict, home: str) -> dict:
    out = {}
    for name, path in written.items():
        with open(path) as fh:
            out[name] = (_norm(path, home), _norm(fh.read(), home),
                         os.access(path, os.X_OK))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_deployment(name, tmp_path):
    seen = {}
    for pkg in ("jax", "torch"):
        _, check, render = _pkg(pkg)
        home = str(tmp_path / pkg)
        seen[pkg] = _files(render(check(CONFIGS[name]), home), home)
    assert seen["torch"] == seen["jax"]
    assert "python -m polyaxon_tpu.cli server" in seen["torch"]["run"][1]


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_values_refused_alike(name):
    errors = {}
    for pkg in ("jax", "torch"):
        _, check, _ = _pkg(pkg)
        with pytest.raises(ValueError) as info:
            check(INVALID[name])
        errors[pkg] = str(info.value)
    assert errors["torch"] == errors["jax"]


@pytest.mark.parametrize("name", ["values", "example"])
def test_admin_deploy_and_teardown(name, tmp_path, monkeypatch):
    """``admin deploy --dry-run``, ``admin deploy`` and ``admin
    teardown`` through both CLIs: the same output and the same files."""
    values_file = tmp_path / "deploy.yaml"
    values_file.write_text(yaml.safe_dump(CONFIGS[name]))
    seen = {}
    for pkg in ("jax", "torch"):
        cli = _pkg(pkg)[0]
        home = str(tmp_path / pkg)
        monkeypatch.setenv("POLYAXON_TPU_HOME", home)
        runner = CliRunner()
        outs = []
        for args in (["--dry-run"], []):
            result = runner.invoke(cli, ["admin", "deploy", "-f",
                                         str(values_file), *args])
            assert result.exit_code == 0, result.output
            outs.append(_norm(result.output, home))
        files = _files(json.loads(result.output), home)
        result = runner.invoke(cli, ["admin", "teardown"])
        assert result.exit_code == 0, result.output
        outs.append(_norm(result.output, home))
        assert not os.path.exists(os.path.join(home, "deploy"))
        seen[pkg] = (outs, files)
    assert seen["torch"] == seen["jax"]
