"""One test body driven through the JAX package and the port at once.

``Twin(jax_obj, torch_obj)`` stands for a pair of corresponding objects
(two modules, two classes, two instances). Calling it, reading an
attribute of it or testing ``in`` on it does the same on both sides,
with every twin among the arguments replaced by its own side's object,
and then:

- both sides must raise alike (the same exception class name and the
  same message, once ``polyaxon_tpu_torch`` is read as
  ``polyaxon_tpu``), and the port's exception is raised on;
- a plain-data result (JSON's scalars, lists, tuples, deques, dicts)
  must be equal on both sides and the port's is returned. Equal means
  exact JSON equality, except that a float may differ by a relative
  1e-12 (``REL``): both sides run the same Python arithmetic, so they
  agree bitwise unless a value comes from a clock;
- any other result is returned as a new twin (an exception class as the
  port's class, so ``pytest.raises`` catches the port's exception).

So a reference test's assertions, run against twins, hold for the port,
and every value they read is also held equal to the JAX package's.
"""

from __future__ import annotations

import math
from collections import deque

REL = 1e-12
_SCALARS = (str, int, float, bool, type(None))


def _plain(x) -> bool:
    if isinstance(x, _SCALARS):
        return True
    if isinstance(x, (list, tuple, deque)):
        return all(_plain(v) for v in x)
    if isinstance(x, dict):
        return all(isinstance(k, _SCALARS) and _plain(v)
                   for k, v in x.items())
    return False


def assert_same(j, t, path: str = "$") -> None:
    """Exact JSON equality of ``j`` and ``t``, floats to REL relative."""
    if isinstance(j, float) and isinstance(t, float):
        if j == t or (math.isnan(j) and math.isnan(t)):
            return
        assert math.isclose(j, t, rel_tol=REL, abs_tol=0.0), (
            f"{path}: jax {j!r} != torch {t!r}")
        return
    assert type(j) is type(t), f"{path}: jax {j!r} != torch {t!r}"
    if isinstance(j, dict):
        assert set(j) == set(t), f"{path}: keys {sorted(j)} != {sorted(t)}"
        for key in j:
            assert_same(j[key], t[key], f"{path}.{key}")
    elif isinstance(j, (list, tuple, deque)):
        assert len(j) == len(t), f"{path}: jax {j!r} != torch {t!r}"
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{path}[{i}]")
    else:
        assert j == t, f"{path}: jax {j!r} != torch {t!r}"


def _is_exc_class(x) -> bool:
    return isinstance(x, type) and issubclass(x, BaseException)


def pair(j, t):
    """The result of one operation on both sides (see the module
    docstring)."""
    if j is t:
        return t
    if _plain(j) and _plain(t):
        assert_same(j, t)
        return t
    if _is_exc_class(j) and _is_exc_class(t):
        assert j.__name__ == t.__name__
        return t
    if (isinstance(j, (list, tuple)) and type(j) is type(t)
            and len(j) == len(t)):
        return type(t)(pair(a, b) for a, b in zip(j, t))
    if isinstance(j, dict) and isinstance(t, dict) and set(j) == set(t):
        return {k: pair(j[k], t[k]) for k in t}
    return Twin(j, t)


def side(x, i: int):
    """``x`` with every twin replaced by its side ``i`` (0 JAX, 1 port);
    containers are rebuilt, so each side gets its own."""
    if isinstance(x, Twin):
        return object.__getattribute__(x, "_pair")[i]
    if isinstance(x, (list, tuple)):
        return type(x)(side(v, i) for v in x)
    if isinstance(x, deque):
        return deque((side(v, i) for v in x), maxlen=x.maxlen)
    if isinstance(x, dict):
        return {k: side(v, i) for k, v in x.items()}
    return x


def _message(exc: BaseException) -> str:
    return str(exc).replace("polyaxon_tpu_torch", "polyaxon_tpu")


def both(fn_j, fn_t, *args, **kwargs):
    """``fn_j`` and ``fn_t`` called on their sides of the arguments."""
    results, errors = [], []
    for i, fn in enumerate((fn_j, fn_t)):
        try:
            results.append(fn(*side(args, i), **side(kwargs, i)))
            errors.append(None)
        except Exception as exc:  # noqa: BLE001 — compared below
            results.append(None)
            errors.append(exc)
    je, te = errors
    if je is not None or te is not None:
        assert je is not None and te is not None, (
            f"only one side raised: jax {je!r}, torch {te!r}")
        assert (type(je).__name__, _message(je)) == (
            type(te).__name__, _message(te))
        raise te
    return pair(*results)


class Twin:
    __slots__ = ("_pair",)

    def __init__(self, j, t):
        object.__setattr__(self, "_pair", (j, t))

    @property
    def jax(self):
        return object.__getattribute__(self, "_pair")[0]

    @property
    def torch(self):
        return object.__getattribute__(self, "_pair")[1]

    def __getattr__(self, name):
        def get(obj):
            return getattr(obj, name)

        return both(get, get, self)

    def __setattr__(self, name, value):
        j, t = object.__getattribute__(self, "_pair")
        setattr(j, name, side(value, 0))
        setattr(t, name, side(value, 1))

    def __call__(self, *args, **kwargs):
        j, t = object.__getattribute__(self, "_pair")
        return both(j, t, *args, **kwargs)

    def __contains__(self, item):
        return both(lambda o, x: x in o, lambda o, x: x in o, self, item)

    def __repr__(self):
        j, t = object.__getattribute__(self, "_pair")
        return f"Twin({j!r}, {t!r})"


def twin_modules(*names: str) -> list[Twin]:
    """``Twin(polyaxon_tpu.<name>, polyaxon_tpu_torch.<name>)`` for each
    dotted module name."""
    import importlib

    return [Twin(importlib.import_module(f"polyaxon_tpu.{n}"),
                 importlib.import_module(f"polyaxon_tpu_torch.{n}"))
            for n in names]
