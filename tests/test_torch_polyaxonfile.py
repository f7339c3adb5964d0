"""The port's spec layer (``polyaxon_tpu_torch.polyaxonfile``,
``polyflow``, ``schemas``) against the JAX package's, on the CPU.

Every Polyaxonfile the repo ships (``examples/*.yaml``,
``tests/fixtures/*.yaml`` and the two specs of ``tests/test_acceptance.py``)
is read by both packages with no preset and with each preset of
``tests/fixtures/presets``, then resolved: the operations must be equal
dict for dict (``to_dict()``), or both packages must refuse with the same
exception class name and message. A matrix operation is resolved once
per trial, with the trial's params drawn by each package's own samplers
from one seed (the draws must be equal too). The patch strategies, preset
idempotence, the Jinja sandbox and ``StrictUndefined`` are held the same
way. Every comparison is exact.
"""

import glob
import os
import random

import pytest

from polyaxon_tpu import polyaxonfile as jpf
from polyaxon_tpu.polyaxonfile import context as jctx
from polyaxon_tpu.polyaxonfile import reader as jreader
from polyaxon_tpu_torch import polyaxonfile as tpf
from polyaxon_tpu_torch.polyaxonfile import context as tctx
from polyaxon_tpu_torch.polyaxonfile import reader as treader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0


def _acceptance_specs():
    from tests.test_acceptance import HYPERBAND_SWEEP, LLAMA_PRETRAIN

    return {"acceptance:LLAMA_PRETRAIN": LLAMA_PRETRAIN,
            "acceptance:HYPERBAND_SWEEP": HYPERBAND_SWEEP}


SPEC_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "examples", "*.yaml"))
    + glob.glob(os.path.join(REPO, "tests", "fixtures", "*.yaml")))
SPECS = SPEC_FILES + ["acceptance:LLAMA_PRETRAIN",
                      "acceptance:HYPERBAND_SWEEP"]
PRESETS = [None] + sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "tests", "fixtures", "presets", "*.yaml")))


def spec_source(spec: str):
    """A spec's source as both packages take it: a path in the repo, or
    an acceptance spec (a YAML string or a dict)."""
    if spec.startswith("acceptance:"):
        return _acceptance_specs()[spec]
    return os.path.join(REPO, spec)


def preset_list(preset):
    return [os.path.join(REPO, preset)] if preset else None


def outcome(fn):
    """("ok", value) or ("raises", class name, message)."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the refusal is the result
        return ("raises", type(exc).__name__, str(exc))


def trial_params(pkg_reader, op) -> dict:
    """One trial's binding of a matrix operation's params: each param
    drawn by the operation's own sampler from ``random.Random(SEED)`` in
    sorted order, a mapping's first row, the hyperband resource at 2."""
    names = pkg_reader.matrix_param_names(op)
    matrix = op.matrix
    rng = random.Random(SEED)
    hps = getattr(matrix, "params", None) or {}
    rows = getattr(matrix, "values", None) or [{}]
    resource = getattr(matrix, "resource", None)
    out = {}
    for name in sorted(names):
        if name in hps:
            out[name] = hps[name].sample(rng)
        elif name in rows[0]:
            out[name] = rows[0][name]
        elif resource is not None and resource.name == name:
            out[name] = 2
    return out


def check_and_resolve(pf, pkg_reader, spec, preset):
    """(checked operation dict, trial params, resolved operation dict),
    each an ``outcome``; a matrix operation is resolved with one trial's
    params bound."""
    checked = outcome(lambda: pf.check_polyaxonfile(
        spec_source(spec), presets=preset_list(preset)))
    if checked[0] != "ok":
        return checked, None, None
    op = checked[1]
    params = trial_params(pkg_reader, op)
    resolved = outcome(lambda: pf.resolve_operation_context(
        op, params=params, run_uuid="uuid-1", run_name="run",
        project_name="proj", artifacts_root="/artifacts").to_dict())
    return ("ok", op.to_dict()), params, resolved


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p and
                         os.path.basename(p).split(".")[0] or "none")
@pytest.mark.parametrize("spec", SPECS)
def test_check_and_resolve_match_jax(spec, preset, monkeypatch):
    monkeypatch.chdir(REPO)
    want = check_and_resolve(jpf, jreader, spec, preset)
    got = check_and_resolve(tpf, treader, spec, preset)
    assert got == want


def test_every_spec_is_held():
    """The parity above covers files that compile and files that are
    refused, and matrix operations with a trial bound."""
    assert len(SPEC_FILES) >= 20 and len(PRESETS) == 3
    outcomes = {spec: check_and_resolve(tpf, treader, spec, None)
                for spec in SPECS}
    resolved = [s for s, (_, _, r) in outcomes.items() if r and r[0] == "ok"]
    refused = [s for s, (c, _, r) in outcomes.items()
               if c[0] != "ok" or r[0] != "ok"]
    trials = [s for s, (_, p, r) in outcomes.items() if p and r[0] == "ok"]
    assert "examples/packed_pretrain.yaml" in resolved
    assert len(trials) >= 4 and refused


def test_unbound_matrix_params_refused_alike():
    spec = spec_source("examples/hyperband_vit.yaml")
    got, want = (outcome(lambda: pf.resolve_operation_context(
        pf.check_polyaxonfile(spec))) for pf in (tpf, jpf))
    assert got == want and got[0] == "raises"
    assert "must be bound per-trial" in got[2]


PATCH_BASE = {"run": {"kind": "jaxjob", "mesh": {"axes": {"dp": 2}},
                      "runtime": {"steps": 10, "lr": None},
                      "tags": ["a", "b"]},
              "queue": None, "name": "base"}
PATCH = {"run": {"mesh": {"axes": {"fsdp": 4}},
                 "runtime": {"steps": 20, "lr": 0.1, "seed": 3},
                 "tags": ["c"]},
         "queue": "q", "name": "patched", "extra": {"k": [1, 2]}}


@pytest.mark.parametrize("strategy", ["post_merge", "pre_merge", "replace",
                                      "isnull", None])
def test_patch_strategies_match_jax(strategy):
    got = tpf.patch_dict(PATCH_BASE, PATCH, strategy)
    assert got == jpf.patch_dict(PATCH_BASE, PATCH, strategy)
    assert PATCH_BASE["run"]["runtime"] == {"steps": 10, "lr": None}


def test_unknown_patch_strategy_refused_alike():
    got, want = (outcome(lambda: pf.patch_dict({}, {"a": 1}, "sideways"))
                 for pf in (tpf, jpf))
    assert got == want and got[0] == "raises"


@pytest.mark.parametrize("preset", PRESETS[1:], ids=lambda p:
                         os.path.basename(p).split(".")[0])
def test_preset_is_idempotent(preset):
    path = spec_source("tests/fixtures/llama3_8b.yaml")
    once = tpf.check_polyaxonfile(path, presets=preset_list(preset))
    twice = tpf.apply_presets(once, preset_list(preset))
    assert twice.to_dict() == once.to_dict()
    assert once.to_dict() == jpf.check_polyaxonfile(
        path, presets=preset_list(preset)).to_dict()


@pytest.mark.parametrize("expr", ["{{ ''.__class__ }}",
                                  "{{ ''.__class__.__mro__[1] }}",
                                  "x {{ params.__class__.__init__ }}"])
def test_sandbox_rejects_dunder_access(expr):
    ctx = {"params": {"lr": 0.1}}
    got, want = (outcome(lambda: mod.render_value(expr, ctx))
                 for mod in (tctx, jctx))
    assert got[0] == "raises" and got[1] == "ContextError"
    assert got == want


@pytest.mark.parametrize("expr", ["{{ params.missing }}",
                                  "lr={{ params.missing }}",
                                  "{{ globals.nope + 1 }}"])
def test_strict_undefined_raises(expr):
    ctx = {"params": {"lr": 0.1}, "globals": tctx.default_globals()}
    got, want = (outcome(lambda: mod.render_value(expr, ctx))
                 for mod in (tctx, jctx))
    assert got[0] == "raises" and got[1] == "ContextError"
    assert got == want


def test_render_keeps_native_types():
    ctx = {"params": {"lr": 0.1, "steps": 4}}
    value = {"a": "{{ params.lr }}", "b": ["{{ params.steps }}", "s{{ params.steps }}"]}
    assert tctx.render_value(value, ctx) == jctx.render_value(value, ctx) \
        == {"a": 0.1, "b": [4, "s4"]}


def test_params_and_patch_overrides_match_jax():
    spec = spec_source("examples/packed_pretrain.yaml")
    kwargs = dict(params={"corpus": "/data/c.txt", "tokenizer": "bytes"},
                  patch={"component": {"run": {"runtime": {"steps": 6}}}},
                  patch_strategy="post_merge")
    got = tpf.check_polyaxonfile(spec, **kwargs).to_dict()
    assert got == jpf.check_polyaxonfile(spec, **kwargs).to_dict()
    assert got["component"]["run"]["runtime"]["steps"] == 6


@pytest.mark.parametrize("source", ["missing/file.yaml", "a: [1, 2\n",
                                    "- 1\n- 2\n", "---\n"])
def test_malformed_sources_refused_alike(source):
    got, want = (outcome(lambda: pf.check_polyaxonfile(source))
                 for pf in (tpf, jpf))
    assert got == want and got[0] == "raises"
