"""The port's host-side timing tools against ``nislam_tpu.utils.profiling``,
and the step-latency script, on the CPU.

``StageTimer`` is held against JAX's under one fake clock (no sleeps): the
same stages give the same totals, counts, means and summary text, and a
stage's fence lies inside its time.  ``device_fence`` reads the leaf JAX's
reads.  ``nislam_torch.scripts.stepbench`` runs 8 frames at 256×256 on
the CPU and prints its lines.  ``device_ms_per_launch`` runs against a fake
stream whose spin holds only as many calls as its launch queue takes: it
halves its calls until they are held, feeding its inputs in one round
across all its calls, and raises when none are.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import tree_util

import nislam_torch.utils.profiling as tprof
import nislam_tpu.utils.profiling as jprof
from nislam_torch.scripts import stepbench

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)


class FakeClock:
    """``time.perf_counter`` that moves only when told to."""

    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def drive(timer, clock, fence):
    """Three 2 ms stages, one 10 ms stage, and a stage whose fence takes
    5 ms (the fence advances the clock)."""
    for _ in range(3):
        with timer.stage("fast"):
            clock.now += 0.002
    with timer.stage("slow"):
        clock.now += 0.010
    with timer.stage("fenced", fence=fence):
        clock.now += 0.001


def test_stage_timer_matches_jax(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock)

    def slow_fence(module):
        real = module.device_fence

        def fence(x):
            real(x)
            clock.now += 0.005

        return fence

    monkeypatch.setattr(tprof, "device_fence", slow_fence(tprof))
    monkeypatch.setattr(jprof, "device_fence", slow_fence(jprof))
    t, j = tprof.StageTimer(), jprof.StageTimer()
    drive(t, clock, torch.ones(4))
    drive(j, clock, jnp.ones(4))
    assert dict(t.count) == dict(j.count) == {"fast": 3, "slow": 1, "fenced": 1}
    for name in ("fast", "slow", "fenced", "never"):
        assert t.total[name] == j.total[name]
        assert t.mean_ms(name) == j.mean_ms(name)
    assert t.mean_ms("fenced") == pytest.approx(6.0)  # the fence's 5 ms counted
    assert t.summary() == j.summary()
    assert t.summary().index("slow") < t.summary().index("fenced") < t.summary().index("fast")


def test_device_fence_reads_jax_s_leaf():
    """The first leaf in JAX's order (dict keys sorted, then sequence
    order); nested containers; a fence on no tensor raises."""
    values = [np.arange(3.0) + k for k in range(4)]
    trees = [
        lambda a: {"b": a[1], "a": (a[0], a[2])},
        lambda a: [{"z": a[3]}, a[0]],
        lambda a: (a[2],),
    ]
    for make in trees:
        want = tree_util.tree_leaves(make([jnp.asarray(v) for v in values]))[0]
        got = tprof._first_tensor(make([torch.from_numpy(v) for v in values]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tprof.device_fence(make([torch.from_numpy(v) for v in values]))
    with pytest.raises(TypeError):
        tprof.device_fence({"a": 1.0})


def test_stepbench_on_the_cpu(capsys):
    assert stepbench.main(["--device", "cpu", "--frames", "8", "--size", "256"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu  256x256 polar 360x64" in out
    assert "dispatch+fence floor: p50" in out
    for label in ("deferred (step, then optimize)", "inline (solve inside the step)"):
        line = next(ln for ln in out.splitlines() if ln.startswith(label))
        assert all(f"{q} " in line for q in ("p50", "p90", "p99", "max")) and "tracked 8/8" in line


def test_stepbench_refuses_a_missing_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    assert stepbench.main(["--frames", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


class FakeStream:
    """``torch.cuda``'s spin, events and synchronize for
    ``device_ms_per_launch`` on the CPU: the spin holds the queued calls
    only while at most ``queue`` of them are queued behind it (a fuller
    launch queue blocks the host until the spin ends), and each event pair
    reads ``ms`` per queued call."""

    def __init__(self, queue: int, ms: float = 0.5):
        self.queue, self.ms, self.queued = queue, ms, 0

    def event(self, enable_timing=True):
        stream = self

        class Event:
            def record(self):
                self.mark = stream.queued

            def query(self):  # the start event: reached once the spin has ended
                return stream.queued > stream.queue

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return stream.ms * (end.mark - self.mark)

        return Event()

    def sleep(self, cycles):
        self.queued = 0


@pytest.mark.parametrize("queue,calls", [(100, 30), (20, 15), (7, 7), (1, 1)])
def test_device_ms_per_launch_halves_its_calls_until_held(monkeypatch, queue, calls):
    stream = FakeStream(queue)
    monkeypatch.setattr(torch.cuda, "Event", stream.event)
    monkeypatch.setattr(torch.cuda, "_sleep", stream.sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    seen = []

    def fn(x):
        seen.append(x)
        stream.queued += 1

    assert tprof.device_ms_per_launch(fn, [1, 2], reps=30) == pytest.approx(0.5)
    # 3 warm calls, 30 to size the spin, then 30, 15, 7, 3, 1 until one holds
    tries = [30, 15, 7, 3, 1]
    assert len(seen) == 3 + 30 + sum(tries[:tries.index(calls) + 1])
    # one round over the inputs through every call: each input is read again
    # only after all the others, however few calls the measurement keeps
    assert seen == [[1, 2][i % 2] for i in range(len(seen))]


def test_device_ms_per_launch_raises_when_nothing_holds(monkeypatch):
    stream = FakeStream(queue=0)
    monkeypatch.setattr(torch.cuda, "Event", stream.event)
    monkeypatch.setattr(torch.cuda, "_sleep", stream.sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def fn(x):
        stream.queued += 1

    with pytest.raises(RuntimeError, match="spins ended"):
        tprof.device_ms_per_launch(fn, [0], reps=4)
