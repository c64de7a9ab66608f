"""Autouse fixtures that keep a port test off the user's plan cache and
calibration: ``dispatch.plan`` reads the persistent plan cache under the
default policy too, and a tuned plan changes the last bits of a GeMM.

A test module imports both names::

    from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
        isolated_plan_cache, isolated_plan_cache_module)

The module fixture points ``REPRO_PLAN_CACHE`` and ``REPRO_CALIBRATION``
at a directory of the module's own before its module-scoped fixtures
build anything; the test fixture gives each test its own files and puts
the process back on them afterwards, so a test that named a cache file
(``--autotune-cache``, ``Engine(autotune_cache=)``) leaves nothing to
the next.
"""

from __future__ import annotations

import pytest


def _point_at(mp: pytest.MonkeyPatch, directory) -> None:
    from repro_torch import dispatch

    mp.setenv("REPRO_PLAN_CACHE", str(directory / "plans.json"))
    mp.setenv("REPRO_CALIBRATION", str(directory / "calibration.json"))
    dispatch.set_cache_path(None)


@pytest.fixture(scope="module", autouse=True)
def isolated_plan_cache_module(tmp_path_factory):
    from repro_torch import dispatch

    with pytest.MonkeyPatch.context() as mp:
        _point_at(mp, tmp_path_factory.mktemp("plans"))
        yield
    dispatch.set_cache_path(None)


@pytest.fixture(autouse=True)
def isolated_plan_cache(isolated_plan_cache_module, tmp_path, monkeypatch):
    from repro_torch import dispatch

    _point_at(monkeypatch, tmp_path)
    yield
    dispatch.set_cache_path(None)
