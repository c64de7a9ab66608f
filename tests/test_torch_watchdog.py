"""Port parity, ``repro_torch.distributed.watchdog``: a twin of
tests/test_watchdog.py (straggler z-score detection, hang-timer arming
and firing, the min_timeout_s floor, the step_finished() stats contract).

Step durations come from a fake ``time.monotonic`` patched into the
module under test, not from sleeps, so the z-score cases are exact under
any load; the hang timer is a real ``threading.Timer``, awaited by
joining it.  The last test feeds the same durations to the reference's
watchdog and compares every result."""

import pytest

pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.distributed import watchdog as jwd  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.distributed import watchdog as wdmod  # noqa: E402
from repro_torch.distributed.watchdog import Watchdog  # noqa: E402


class FakeTime:
    """``time.monotonic`` that moves only when told to."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    fake = FakeTime()
    monkeypatch.setattr(wdmod, "time", fake)
    return fake


@pytest.fixture(autouse=True)
def _clean_registry():
    obs.registry().reset()
    yield
    obs.registry().reset()


def _step(wd, clock, dt=0.0):
    wd.step_started()
    clock.t += dt
    return wd.step_finished()


def test_no_arming_before_min_steps(clock):
    wd = Watchdog(min_steps=5, min_timeout_s=0.01)
    for _ in range(5):
        wd.step_started()
        assert wd._timer is None  # not enough history yet
        info = wd.step_finished()
        assert info["straggler"] is False and info["step_time"] >= 0.0
    wd.step_started()
    assert wd._timer is not None  # history primed, timer armed
    wd.step_finished()
    assert wd._timer is None  # cancelled on finish
    assert wd.hang_count == 0


def test_hang_timer_fires_and_counts(clock):
    fired = []
    wd = Watchdog(min_steps=2, min_timeout_s=0.05,
                  on_hang=lambda: fired.append(True))
    for _ in range(3):
        _step(wd, clock)
    wd.step_started()
    timer = wd._timer
    assert timer.interval >= 0.05  # floor respected on tiny means
    timer.join(timeout=10.0)  # the step stalls past the timer
    assert not timer.is_alive()
    wd.step_finished()
    assert wd.hang_count == 1 and fired == [True]
    assert obs.registry().value("counter", "watchdog_hangs_total") == 1


def test_min_timeout_floor(clock):
    wd = Watchdog(min_steps=2, min_timeout_s=5.0)
    for _ in range(3):
        _step(wd, clock, 1e-6)  # mean is microseconds; floor must dominate
    wd.step_started()
    assert wd._timer.interval == pytest.approx(5.0)
    wd.step_finished()
    assert wd.hang_count == 0


def test_hang_timeout_scales_with_the_mean(clock):
    wd = Watchdog(min_steps=2, hang_factor=10.0, min_timeout_s=0.01)
    for _ in range(3):
        _step(wd, clock, 0.5)
    wd.step_started()
    assert wd._timer.interval == pytest.approx(5.0)  # 10 x the 0.5 s mean
    wd.step_finished()


def test_straggler_zscore_detection(clock):
    seen = []
    wd = Watchdog(min_steps=3, z_threshold=4.0, min_timeout_s=10.0,
                  on_straggler=lambda dt, mean, std: seen.append(dt))
    # prime with steps of small but nonzero spread so std > 0
    for dt in (0.001, 0.002, 0.001, 0.002, 0.001):
        _step(wd, clock, dt)
    assert wd.straggler_count == 0
    info = _step(wd, clock, 0.08)  # >> mean + 4 std
    assert info["straggler"] is True
    assert info["step_time"] == pytest.approx(0.08)
    assert wd.straggler_count == 1
    assert seen and seen[0] == pytest.approx(info["step_time"])
    assert obs.registry().value(
        "counter", "watchdog_stragglers_total") == 1


def test_straggler_sample_joins_history(clock):
    wd = Watchdog(min_steps=2, min_timeout_s=10.0)
    for _ in range(4):
        _step(wd, clock)
    before = len(wd._times)
    _step(wd, clock)
    assert len(wd._times) == before + 1


def test_window_bounds_stats():
    wd = Watchdog(window=4, min_steps=2, min_timeout_s=10.0)
    wd._times.extend([10.0, 10.0, 0.001, 0.001, 0.001, 0.001])
    mean, std = wd._stats()
    # only the last `window` samples count: the 10s outliers age out
    assert mean == pytest.approx(0.001)
    assert std == pytest.approx(0.0)


def test_matches_reference_on_the_same_durations(clock, monkeypatch):
    """The same step durations through both watchdogs: the same infos,
    timeouts, straggler counts and counters."""
    ref_clock = FakeTime()
    monkeypatch.setattr(jwd, "time", ref_clock)
    jobs.registry().reset()
    durations = [0.010, 0.011, 0.009, 0.010, 0.012, 0.010, 0.2, 0.010,
                 0.011, 0.5, 0.010, 0.009, 0.010, 0.3]
    kw = dict(window=6, z_threshold=3.0, min_steps=4, min_timeout_s=60.0)
    ours, theirs = Watchdog(**kw), jwd.Watchdog(**kw)
    for dt in durations:
        for wd, c in ((ours, clock), (theirs, ref_clock)):
            wd.step_started()
            c.t += dt
        assert (ours._timer is None) == (theirs._timer is None)
        if ours._timer is not None:
            assert ours._timer.interval == theirs._timer.interval
        assert ours.step_finished() == theirs.step_finished()
    assert ours.straggler_count == theirs.straggler_count > 0
    assert ours._stats() == theirs._stats()
    assert obs.registry().value("counter", "watchdog_stragglers_total") \
        == jobs.registry().value("counter", "watchdog_stragglers_total")
    jobs.registry().reset()
