"""Test-suite bootstrap.

Provides a minimal, deterministic stand-in for ``hypothesis`` when the
real package is not installed (the kernel container ships without it).
The stub replays a fixed number of pseudo-random examples per property
(seeded from the test name), supporting exactly the API surface this
suite uses: ``given``, ``settings``, ``assume`` and the strategies
``integers``, ``floats``, ``booleans``, ``sampled_from``, ``lists`` and
``builds``.  When the real hypothesis is importable it is used as-is.
"""
from __future__ import annotations

import random
import sys
import types


def _install_hypothesis_stub() -> None:
    class UnsatisfiedAssumption(Exception):
        pass

    class Strategy:
        def __init__(self, sample):
            self._sample = sample

        def sample(self, rnd: random.Random):
            return self._sample(rnd)

    def integers(min_value, max_value):
        return Strategy(lambda rnd: rnd.randint(min_value, max_value))

    def floats(min_value=0.0, max_value=1.0, allow_nan=False,
               allow_infinity=False, **_kw):
        return Strategy(lambda rnd: rnd.uniform(min_value, max_value))

    def booleans():
        return Strategy(lambda rnd: rnd.random() < 0.5)

    def sampled_from(elements):
        elements = list(elements)
        return Strategy(lambda rnd: rnd.choice(elements))

    def lists(elements, min_size=0, max_size=None):
        hi = max_size if max_size is not None else min_size + 5

        def sample(rnd):
            return [elements.sample(rnd)
                    for _ in range(rnd.randint(min_size, hi))]

        return Strategy(sample)

    def builds(target, *arg_strats, **kw_strats):
        def sample(rnd):
            args = [s.sample(rnd) for s in arg_strats]
            kwargs = {k: s.sample(rnd) for k, s in kw_strats.items()}
            return target(*args, **kwargs)

        return Strategy(sample)

    def assume(condition):
        if not condition:
            raise UnsatisfiedAssumption()
        return True

    def settings(**kw):
        def deco(fn):
            fn._stub_settings = kw
            return fn

        return deco

    _MAX_EXAMPLES_CAP = 20  # keep the deterministic replay fast

    def given(*strategies):
        def deco(fn):
            declared = getattr(fn, "_stub_settings", {})

            def wrapper():
                cfg = getattr(wrapper, "_stub_settings", None) or declared
                n = min(cfg.get("max_examples", 10), _MAX_EXAMPLES_CAP)
                rnd = random.Random(fn.__qualname__)
                ran = 0
                attempts = 0
                while ran < n and attempts < 10 * n:
                    attempts += 1
                    try:
                        fn(*[s.sample(rnd) for s in strategies])
                    except UnsatisfiedAssumption:
                        continue
                    ran += 1

            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__module__ = fn.__module__
            wrapper.__doc__ = fn.__doc__
            return wrapper

        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.assume = assume
    mod.UnsatisfiedAssumption = UnsatisfiedAssumption
    strat_mod = types.ModuleType("hypothesis.strategies")
    for name, obj in [
        ("integers", integers), ("floats", floats), ("booleans", booleans),
        ("sampled_from", sampled_from), ("lists", lists), ("builds", builds),
    ]:
        setattr(strat_mod, name, obj)
    mod.strategies = strat_mod
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = strat_mod


try:  # pragma: no cover - trivially environment-dependent
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()


def pytest_configure(config):
    """Point the autotune spec cache at a throwaway path so test runs
    never touch (or depend on) the user's ~/.cache store."""
    import os
    import tempfile

    config.addinivalue_line(
        "markers", "card: runs only on a CUDA card (the test skips itself "
        "when none is visible); on the card: python -m pytest -m card "
        "tests/test_torch_*.py")
    if "REPRO_AUTOTUNE_CACHE" not in os.environ:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(
            tempfile.mkdtemp(prefix="repro-autotune-"), "cache.json"
        )


def _install_shard_map_alias() -> None:
    """jax.shard_map graduated from jax.experimental in newer releases;
    alias it on older jax so tests run unmodified on both.  The old
    experimental replication checker has known false positives (e.g. on
    scan carries — its own error message suggests check_rep=False as the
    workaround), so the alias defaults it off."""
    import functools

    import jax

    if not hasattr(jax, "shard_map"):
        from jax.experimental.shard_map import shard_map

        @functools.wraps(shard_map)
        def compat(f, **kw):
            kw.setdefault("check_rep", False)
            return shard_map(f, **kw)

        jax.shard_map = compat


_install_shard_map_alias()
