"""The yardstick's arithmetic: the rate is taken over the whole window, the
tail over every request."""

import types

import numpy as np
import pytest

from benchmarks.harness import catalog, stats
from benchmarks.harness.window import Request, Window


def _record(durations, frames_per_request=64, gap=0.01):
    reqs, t = [], 100.0
    for d in durations:
        reqs.append(Request(t, t + d, frames_per_request, frames_per_request, 0))
        t += d + gap
    win = Window(100.0, reqs[-1].t1, reqs, {}, {}, {}, [], 7)
    return types.SimpleNamespace(window=win, setup_s=12.5, spans=None, counters=None, trace=False)


def test_rate_is_every_frame_over_the_whole_window_with_its_gaps():
    rec = _record([0.1] * 10, gap=0.05)
    fps = catalog.metric_reader("frames_per_s").read(rec)
    assert fps == pytest.approx(640 / (10 * 0.1 + 9 * 0.05))
    assert fps < 640 / 1.0  # the gaps between requests count


def test_p95_is_over_every_request_not_a_median_of_groups():
    durs = [0.05] * 95 + [0.3] * 5
    rec = _record(durs)
    p95 = catalog.metric_reader("chunk_ms_p95").read(rec)
    assert p95 == pytest.approx(np.percentile(np.array(durs) * 1e3, 95))
    assert p95 > 50.0


def test_percentile_matches_numpy():
    xs = list(np.random.default_rng(1).random(257))
    for q in (0, 50, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_roofline_share_of_the_peak_stats_bytes():
    from benchmarks.harness.probes import registration_stats_bytes

    bound = stats.bytes_bound_s(registration_stats_bytes(480, 640))
    assert bound == pytest.approx((480 * 640 * 4 + 32) / 3.35e12)
    assert stats.roofline_share(bound, 2 * bound) == pytest.approx(50.0)


def test_syncs_per_chunk_and_setup():
    rec = _record([0.1] * 7)
    assert catalog.metric_reader("host_syncs_per_chunk").read(rec) == pytest.approx(1.0)
    assert catalog.metric_reader("setup_s").read(rec) == 12.5


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = _record([0.1] * 3)
    for name in ("device_idle_share", "stored_frames_share", "solve_ms", "lm_iters_per_solve"):
        assert catalog.metric_reader(name).read(rec) is None
