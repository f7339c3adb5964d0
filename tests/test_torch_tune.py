"""The port's search managers (``polyaxon_tpu_torch.tune``) against the
JAX package's (``polyaxon_tpu.tune``), on the CPU.

For each matrix kind (grid, random, mapping, iterative, hyperband, asha,
bayes, hyperopt) the same spec, parsed by each package's own
``polyflow.matrix``, goes through both packages' managers with the same
seed and the same scripted observations (a fixed objective of the
suggested params). The suggestions must be equal and in equal order:
exactly, except bayes and hyperopt, whose floats may differ by up to
1e-9 relative (numpy and scipy reductions).
"""

import math

import pytest

PKGS = ("jax", "torch")
FLOAT_REL = 1e-9


def modules(pkg: str):
    if pkg == "jax":
        from polyaxon_tpu import tune
        from polyaxon_tpu.polyflow import matrix
    else:
        from polyaxon_tpu_torch import tune
        from polyaxon_tpu_torch.polyflow import matrix
    return tune, matrix


def objective(params: dict) -> float:
    """A fixed loss of the params: squared distance of each number from
    0.3 (log-scaled when positive and far from it), string lengths."""
    loss = 0.0
    for name in sorted(params):
        value = params[name]
        if isinstance(value, str):
            loss += 0.01 * len(value)
        elif isinstance(value, bool) or value is None:
            loss += 0.5
        else:
            v = float(value)
            if v > 10 or 0 < v < 1e-2:
                v = math.log10(v)
            loss += (v - 0.3) ** 2
    return loss


SPACES = {
    "mixed": {
        "lr": {"kind": "loguniform",
               "value": {"low": math.log(1e-5), "high": math.log(1e-1)}},
        "dropout": {"kind": "uniform", "value": {"low": 0.0, "high": 0.5}},
        "layers": {"kind": "choice", "value": [2, 4, 8]},
    },
    "spaced": {
        "a": {"kind": "range", "value": [0, 10, 3]},
        "b": {"kind": "linspace", "value": [0, 1, 4]},
        "c": {"kind": "logspace", "value": [-3, -1, 3]},
        "d": {"kind": "geomspace", "value": [1, 64, 4]},
    },
    "quantized": {
        "x": {"kind": "quniform", "value": {"low": 0, "high": 1, "q": 0.1}},
        "y": {"kind": "qloguniform",
              "value": {"low": 0, "high": math.log(100), "q": 1}},
        "z": {"kind": "pchoice",
              "value": [["adam", 0.5], ["sgd", 0.3], ["lion", 0.2]]},
    },
    "normal": {
        "x": {"kind": "normal", "value": {"loc": 0.3, "scale": 0.1}},
        "y": {"kind": "lognormal", "value": {"loc": 0.0, "scale": 0.5}},
        "z": {"kind": "qnormal", "value": {"loc": 1.0, "scale": 2.0,
                                             "q": 0.5}},
    },
}
GRID_SPACES = ("spaced",)
RANDOM_SPACES = ("mixed", "spaced", "quantized", "normal")
METRIC = {"name": "loss", "optimization": "minimize"}


def run_grid(pkg, space, seed):
    tune, matrix = modules(pkg)
    spec = {"kind": "grid", "params": SPACES[space], "numRuns": 40}
    return tune.GridSearchManager(
        matrix.V1GridSearch.from_dict(spec)).get_suggestions()


def run_random(pkg, space, seed):
    tune, matrix = modules(pkg)
    spec = {"kind": "random", "params": SPACES[space], "numRuns": 12,
            "seed": seed}
    return tune.RandomSearchManager(
        matrix.V1RandomSearch.from_dict(spec)).get_suggestions()


def run_mapping(pkg, space, seed):
    tune, matrix = modules(pkg)
    spec = {"kind": "mapping",
            "values": [{"lr": 0.1 * i, "layers": i, "opt": "adam"}
                       for i in range(1, 5)]}
    return tune.MappingManager(
        matrix.V1Mapping.from_dict(spec)).get_suggestions()


def run_iterative(pkg, space, seed):
    tune, matrix = modules(pkg)
    spec = {"kind": "iterative", "params": SPACES[space], "maxIterations": 6,
            "seed": seed}
    mgr = tune.IterativeManager(matrix.V1Iterative.from_dict(spec))
    out, obs = [], []
    for i in range(6):
        params = mgr.get_suggestion(i, obs)
        out.append(params)
        obs.append(tune.Observation(params=params, metric=objective(params)))
    return out


def run_hyperband(pkg, space, seed):
    """Every bracket: the first rung, then each promotion from the
    scripted metrics; one trial per rung reported failed and one
    preempted (reissued at its rung)."""
    tune, matrix = modules(pkg)
    spec = {"kind": "hyperband", "maxIterations": 9, "eta": 3,
            "resource": {"name": "steps", "type": "int"},
            "metric": METRIC, "params": SPACES[space], "seed": seed}
    mgr = tune.HyperbandManager(matrix.V1Hyperband.from_dict(spec))
    out = [("total", mgr.total_trials(), mgr.brackets())]
    for s in mgr.brackets():
        rung = mgr.first_rung(s)
        i = 0
        while rung is not None:
            out.append((s, rung.rung, rung.n_configs, rung.resource,
                        rung.suggestions))
            obs = []
            for k, params in enumerate(rung.suggestions):
                status = ("failed" if k == 1 else
                          "preempted" if k == 2 else "succeeded")
                obs.append(tune.Observation(
                    params=params, status=status,
                    metric=objective(params) if status == "succeeded"
                    else None))
            out.append(("reissue", mgr.reissue_preempted(obs)))
            out.append(("top", [o.params for o in tune.top_k(
                obs, matrix.V1OptimizationMetric.from_dict(METRIC), 2)]))
            rung = mgr.next_rung(s, i, obs)
            i += 1
    return out


def run_asha(pkg, space, seed):
    tune, matrix = modules(pkg)
    spec = {"kind": "asha", "maxIterations": 27, "minResource": 1, "eta": 3,
            "numRuns": 9, "resource": {"name": "steps", "type": "int"},
            "metric": METRIC, "params": SPACES[space], "seed": seed}
    mgr = tune.AshaManager(matrix.V1Asha.from_dict(spec))
    draws = [mgr.sample_params(i) for i in range(9)]
    draws += [mgr.sample_params(i, base_seed=seed + 5) for i in range(3)]
    completed = [(f"t{i}", p, None if i == 4 else objective(p))
                 for i, p in enumerate(draws[:9])]
    return [mgr.rungs, mgr.n_rungs(), draws,
            mgr.promotable(completed), mgr.promotable(completed[:5]),
            mgr.promotable(completed[:2])]


def run_bayes(pkg, space, seed):
    """Initial draws, then three model-based rounds of two suggestions,
    each observed before the next round."""
    tune, matrix = modules(pkg)
    spec = {"kind": "bayes", "numInitialRuns": 4, "maxIterations": 6,
            "metric": METRIC, "params": SPACES[space], "seed": seed,
            "utilityFunction": {"acquisitionFunction": "ei",
                                "gaussianProcess": {"kernel": "matern",
                                                    "lengthScale": 0.5}}}
    mgr = tune.BayesManager(matrix.V1Bayes.from_dict(spec))
    out = [mgr.initial_suggestions()]
    obs = [tune.Observation(params=p, metric=objective(p)) for p in out[0]]
    for _ in range(3):
        picked = mgr.get_suggestions(obs, count=2, n_candidates=200)
        out.append(picked)
        obs += [tune.Observation(params=p, metric=objective(p))
                for p in picked]
    out.append(mgr.is_done(obs))
    return out


def run_hyperopt(pkg, space, seed, algorithm="tpe"):
    tune, matrix = modules(pkg)
    spec = {"kind": "hyperopt", "algorithm": algorithm, "numRuns": 12,
            "metric": METRIC, "params": SPACES[space], "seed": seed}
    mgr = tune.HyperoptManager(matrix.V1Hyperopt.from_dict(spec))
    out = [mgr.initial_suggestions()]
    obs = [tune.Observation(params=p, metric=objective(p)) for p in out[0]]
    for _ in range(3):
        picked = mgr.get_suggestions(obs, count=3)
        out.append(picked)
        obs += [tune.Observation(params=p, metric=objective(p))
                for p in picked]
    out.append(mgr.is_done(obs))
    return out


CASES = (
    [("grid", s, 0, run_grid) for s in GRID_SPACES]
    + [("random", s, seed, run_random) for s in RANDOM_SPACES
       for seed in (0, 7)]
    + [("mapping", "values", 0, run_mapping)]
    + [("iterative", s, 3, run_iterative) for s in RANDOM_SPACES]
    + [("hyperband", s, 7, run_hyperband) for s in ("mixed", "quantized")]
    + [("asha", s, 11, run_asha) for s in ("mixed", "normal")]
    + [("bayes", s, 5, run_bayes) for s in ("mixed", "spaced", "quantized")]
    + [(f"hyperopt-{a}", s, 7,
        lambda p, sp, sd, a=a: run_hyperopt(p, sp, sd, algorithm=a))
       for a in ("tpe", "anneal", "rand") for s in ("mixed", "quantized")]
)


def assert_same(a, b, rel: float, where: str = ""):
    if isinstance(a, float) and isinstance(b, float):
        if rel == 0.0:
            assert a == b, where
        else:
            assert math.isclose(a, b, rel_tol=rel, abs_tol=0.0), \
                (where, a, b)
        return
    assert type(a) is type(b), (where, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], rel, f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, rel, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("kind,space,seed,run", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_suggestions_equal(kind, space, seed, run):
    jax_out = run("jax", space, seed)
    torch_out = run("torch", space, seed)
    rel = FLOAT_REL if kind.startswith(("bayes", "hyperopt")) else 0.0
    assert_same(jax_out, torch_out, rel)
    assert jax_out  # the driver produced suggestions


@pytest.mark.parametrize("kind", ["ucb", "ei", "poi"])
def test_acquisition_and_gp_equal(kind):
    """The Bayes manager's GP posterior and acquisition scores, on the
    same points, to 1e-9 relative."""
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.random((6, 2))
    y = rng.random(6)
    q = rng.random((20, 2))
    outs = []
    for pkg in PKGS:
        tune, _ = modules(pkg)
        gp = tune.GaussianProcess(kernel="matern", length_scale=0.4)
        gp.fit(x, y)
        mean, std = gp.predict(q)
        outs.append((mean, std, tune.acquisition(kind, mean, std,
                                                 best=float(y.max()))))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=FLOAT_REL, atol=0.0)


def test_early_stopping_equal():
    """``check_early_stopping`` over the same policies and observations."""
    results = []
    for pkg in PKGS:
        tune, _ = modules(pkg)
        obs = [tune.Observation(params={"x": 0.1}, metric=0.4),
               tune.Observation(params={"x": 0.2}, metric=None,
                                status="failed"),
               tune.Observation(params={"x": 0.3}, metric=None,
                                status="preempted")]
        policies = [
            [{"kind": "metric_early_stopping", "metric": "loss",
              "value": 0.5, "optimization": "minimize"}],
            [{"kind": "metric_early_stopping", "metric": "loss",
              "value": 0.1, "optimization": "minimize"}],
            [{"kind": "failure_early_stopping", "percent": 50}],
            [{"kind": "failure_early_stopping", "percent": 60}],
            None,
        ]
        results.append([tune.check_early_stopping(p, lambda _m: obs)
                        for p in policies])
    assert results[0] == results[1] == ["succeed", None, "fail", None, None]
