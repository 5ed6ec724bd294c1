"""sum_only and pkbench: the plain version against what the Pallas
``sum_only_pallas`` computes (``jnp.sum``), pkbench's interleave helper on
the CPU with plain variants, and the CUDA kernel against the plain version
on the card.

Sums taken in another order differ in the last bits: every comparison is
within 1e-5 of Σ|x|.  The cases marked ``gpu`` run the kernel and skip
without a CUDA device.
"""

import numpy as np
import pytest
import torch

from nislam_torch.kernels import launch
from nislam_torch.ops import peak_stats as tps
from nislam_torch.ops import sum_only as tso
from nislam_torch.scripts import pkbench

# The suite runs in parallel worker processes: one intra-op thread, since
# OpenMP's spare threads spin between operations on cores that the other
# workers (sleep-based timing tests among them) need.
torch.set_num_threads(1)

KERNEL_SHAPES = [(1200, 1600), (480, 640), (8, 2, 1200, 1600), (20, 130)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sum_only kernel has no CPU mode")
    return torch.device("cuda")


def assert_sums_close(got, want, x):
    tol = 1e-5 * np.abs(np.asarray(x, np.float64)).sum(axis=(-2, -1))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= tol).all(), (err, tol)


@pytest.mark.parametrize("shape", [(1200, 1600), (3, 24, 32), (2, 3, 20, 130)])
def test_reference_matches_jnp_sum(rng, shape):
    import jax.numpy as jnp

    x = rng.standard_normal(shape).astype(np.float32)
    got = tso.sum_only(torch.from_numpy(x))
    assert got.shape == shape[:-2] and got.dtype == torch.float32
    assert_sums_close(got.numpy(), np.asarray(jnp.sum(jnp.asarray(x), axis=(-2, -1))), x)


def test_dispatch():
    x = torch.ones(4, 6)
    before = tso.sum_only.launches
    assert float(tso.sum_only(x)) == 24.0
    assert float(tso.sum_only(x, force="reference")) == 24.0
    assert tso.sum_only.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError):
        tso.sum_only(x, force="kernel")  # a CPU tensor cannot take the kernel
    with pytest.raises(ValueError):
        tso.sum_only(x, force="pallas")


def test_peak_stats_rows_pins_the_bands():
    # (blocks per array, float4s per block, 4): bands of whole rows
    assert launch.block_ranges(1, 1200, 1600, 600) == (2, 600 * 400, 4)
    assert launch.block_ranges(1, 1200, 1600, 320) == (4, 320 * 400, 4)
    assert launch.block_ranges(1, 20, 130, 600) == (1, 650, 4)
    assert launch.block_ranges(1, 20, 130, 3) == (7, 390, 1)  # 390 floats: no multiple of 4
    with pytest.raises(ValueError):
        launch.block_ranges(1, 20, 130, 0)
    g = torch.zeros(4, 6)
    assert tps.peak_stats(g, rows=2)[1].dtype == torch.int32  # the plain version ignores rows


def test_interleave_helper_on_plain_variants(rng):
    """pkbench's interleave on the CPU: every variant timed once per
    round, in turn, with a host timer; µs per launch come back per round."""
    x = torch.from_numpy(rng.random((48, 64), dtype=np.float32))
    calls = []

    def timer(fn, inputs, reps):
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        calls.append(fn)
        return 0.5

    variants = {"jnp4pass": tps.peak_stats_reference, "sumonly": tso.sum_only_reference,
                "torch.sum": lambda t: torch.sum(t, dim=(-2, -1))}
    times = pkbench.interleave(variants, [x, x.clone()], rounds=3, reps=4, timer=timer)
    assert list(times) == list(variants)
    assert all(ts == [500.0] * 3 for ts in times.values())
    assert calls == list(variants.values()) * 3  # interleaved: A, B, C, A, B, C, ...
    summary = pkbench.summarize(times, bound_us=2.29)
    assert summary["sumonly"]["med_us"] == 500.0
    assert summary["sumonly"]["bound_share"] == pytest.approx(2.29 / 500.0)


def test_pkbench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pkbench.main([]) != 0
    assert "CUDA" in capsys.readouterr().err


def test_cold_copies_exceed_the_cache():
    from nislam_torch.utils.profiling import COLD_BYTES, bound_ms, cold_copies

    x = torch.zeros(1200, 1600)
    copies = cold_copies(x, reps=100)
    assert sum(c.numel() * 4 for c in copies) >= COLD_BYTES and copies[0] is x
    assert len(cold_copies(torch.zeros(4, 4), reps=7)) == 7
    ms, by = bound_ms(7.68e6)
    assert by == "bytes" and ms == pytest.approx(7.68e6 / 3.35e12 * 1e3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_kernel_matches_reference(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda)
    before = tso.sum_only.launches
    got = tso.sum_only(x)
    assert tso.sum_only.launches == before + 1
    assert_sums_close(got.cpu().numpy(), tso.sum_only_reference(x).cpu().numpy(), x.cpu().numpy())


@pytest.mark.gpu
def test_kernel_constant_and_deterministic(cuda):
    x = torch.full((1200, 1600), 0.25, device=cuda)
    assert float(tso.sum_only(x)) == 0.25 * 1200 * 1600  # exact: every partial is exact
    y = torch.randn((8, 2, 1200, 1600), device=cuda)
    assert torch.equal(tso.sum_only(y), tso.sum_only(y))  # a fixed merge order


@pytest.mark.gpu
def test_kernel_many_launches_share_the_workspace(cuda):
    """sum_only and peak_stats take turns on one stream and one workspace."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    xs = [torch.randn(shape, generator=gen, device=cuda) for shape in ((1200, 1600), (8, 2, 480, 640))]
    first = [tso.sum_only(x) for x in xs]
    peaks = [tps.peak_stats(x) for x in xs]
    for i in range(500):
        assert torch.equal(tso.sum_only(xs[i % 2]), first[i % 2])
        assert all(torch.equal(a, b) for a, b in zip(tps.peak_stats(xs[i % 2]), peaks[i % 2]))


@pytest.mark.gpu
def test_launch_floor_is_measured(cuda):
    from nislam_torch.utils.profiling import launch_floor_ms

    floor = launch_floor_ms(reps=200)
    assert 0.0 < floor < 0.1  # an empty kernel: microseconds, not a tenth of a millisecond


@pytest.mark.gpu
def test_peak_stats_rows_on_the_kernel(cuda):
    g = torch.randn((1200, 1600), device=cuda)
    want = tps.peak_stats_reference(g)
    for rows in (600, 320, 1):
        got = tps.peak_stats(g, rows=rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
