"""peak_stats: the plain torch version against the JAX paths, and the CUDA
kernel against the plain version on the card (port of
tests/test_pallas_kernels.py).

On the CPU the torch reference is held against ``_jnp_peak_stats`` and
against both Pallas TPU kernels run in the TPU interpreter.  Peak and
argmax must be exactly equal; Σg and Σg² to rtol 1e-5 (f32 sums taken in
another order).  The cases marked ``gpu`` run the kernel and skip without
a CUDA device; they need no JAX, which is imported only by the tests that
use it.
"""

import numpy as np
import pytest
import torch

from nislam_torch.ops import peak_stats as tps
from nislam_torch.ops.registration import psr

# The suite runs in parallel worker processes: keep torch from taking every core.
torch.set_num_threads(2)


@pytest.fixture
def jx():
    """The JAX package's peak_stats module, with jax and jax.numpy."""
    import jax
    import jax.numpy as jnp

    from nislam_tpu.ops import pallas_kernels

    return jax, jnp, pallas_kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the peak_stats kernel has no CPU mode")
    return torch.device("cuda")


def assert_stats_equal(got, want, rtol=1e-5):
    got = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32
    np.testing.assert_allclose(got[2], want[2], rtol=rtol)
    np.testing.assert_allclose(got[3], want[3], rtol=rtol)


def interpret(jx, fn, g):
    from jax.experimental.pallas import tpu as pltpu

    jax, jnp, _ = jx
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(fn)(jnp.asarray(g))


def tie_cases():
    """(g, expected row-major index): the column-major-first max wins."""
    g = np.zeros((8, 8), np.float32)
    g[2, 3] = g[5, 1] = 5.0  # cm 26 vs 13 → (5, 1)
    yield g, 5 * 8 + 1
    g = np.zeros((24, 128), np.float32)
    g[5, 1] = g[17, 0] = 7.0  # different row blocks; cm 29 vs 17 → (17, 0)
    yield g, 17 * 128
    g = np.full((20, 130), -1.0, np.float32)
    g[19, 0] = g[0, 129] = g[19, 129] = 5.0  # ragged, last rows → (19, 0)
    yield g, 19 * 130
    g = np.zeros((300, 400), np.float32)  # the coarse loop-search response at HD/4
    g[10, 7] = g[299, 3] = g[250, 3] = 4.0  # cm 2110, 1199, 1150 → (250, 3)
    yield g, 250 * 400 + 3


@pytest.mark.parametrize("shape", [(3, 24, 32), (16, 128), (2, 3, 20, 130)])
def test_reference_matches_jnp_and_oracle(rng, jx, shape):
    _, jnp, pk = jx
    g = rng.standard_normal(shape).astype(np.float32)
    got = tps.peak_stats(torch.from_numpy(g))
    assert_stats_equal(got, pk._jnp_peak_stats(jnp.asarray(g)))
    flat = g.reshape(*shape[:-2], -1)
    np.testing.assert_array_equal(got[1].numpy(), flat.argmax(-1))
    np.testing.assert_allclose(got[2].numpy(), flat.sum(-1, dtype=np.float64), rtol=1e-5)


@pytest.mark.parametrize("case", range(4))
def test_column_major_tiebreak(jx, case):
    _, jnp, pk = jx
    g, want = list(tie_cases())[case]
    _, idx, _, _ = tps.peak_stats_reference(torch.from_numpy(g))
    assert int(idx) == want
    _, jidx, _, _ = pk._jnp_peak_stats(jnp.asarray(g))
    assert int(jidx) == want


def test_psr_from_stats_matches_psr(rng):
    g = torch.from_numpy(rng.random((16, 20)).astype(np.float32))
    peak, _, s, ss = tps.peak_stats(g)
    np.testing.assert_allclose(float(tps.psr_from_stats(peak, s, ss, 320)), float(psr(g, peak)), rtol=1e-4)


@pytest.mark.parametrize("shape", [(16, 128), (3, 16, 128)])
def test_reference_matches_pallas_2d_interpret(rng, jx, shape):
    """The single-block Pallas kernel, vmapped over the batch as
    ``nislam_tpu`` runs it."""
    jax, _, pk = jx
    g = rng.standard_normal(shape).astype(np.float32)
    fn = pk._pallas_peak_stats_2d
    for _ in range(len(shape) - 2):
        fn = jax.vmap(fn)
    assert_stats_equal(tps.peak_stats(torch.from_numpy(g)), interpret(jx, fn, g))


@pytest.mark.parametrize("h,w,bh", [(32, 128, 8), (20, 128, 8), (24, 256, 24)])
def test_reference_matches_pallas_blocked_interpret(rng, jx, h, w, bh):
    """The row-blocked kernel, including the masked tail at h=20."""
    g = rng.standard_normal((2, h, w)).astype(np.float32)
    want = interpret(jx, lambda x: jx[2]._pallas_peak_stats_blocked(x, bh), g)
    assert_stats_equal(tps.peak_stats(torch.from_numpy(g)), want)


def test_tie_across_blocks_matches_pallas_blocked(jx):
    g, want = list(tie_cases())[1]
    _, idx, _, _ = interpret(jx, lambda x: jx[2]._pallas_peak_stats_blocked(x, 8), g)
    assert int(idx) == want == int(tps.peak_stats(torch.from_numpy(g))[1])


def test_dispatch():
    g = torch.zeros(4, 6)
    before = tps.peak_stats.launches
    tps.peak_stats(g)
    tps.peak_stats(g, force="reference")
    assert tps.peak_stats.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError):
        tps.peak_stats(g, force="kernel")  # a CPU tensor cannot take the kernel
    with pytest.raises(ValueError):
        tps.peak_stats(g, force="pallas")


def test_bands_cover_every_row():
    for b in (1, 2, 8, 16, 600):
        for h in (1, 20, 360, 480, 1200):
            s, rows = tps._bands(b, h)
            assert s * rows >= h > (s - 1) * rows and s >= 1


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [(360, 480), (480, 640), (8, 2, 480, 640), (1200, 1600), (20, 130), (3, 17, 33),
     # the HD deployment's coarse-to-fine loop search: the rotation stage,
     # the two-hypothesis ranking at 1/4 resolution, the winner's hypotheses
     (8, 360, 480), (8, 2, 300, 400), (2, 1200, 1600)],
)
def test_kernel_matches_reference(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    g = torch.randn(shape, generator=gen, device=cuda)
    before = tps.peak_stats.launches
    got = tps.peak_stats(g)
    assert tps.peak_stats.launches == before + 1
    assert_stats_equal(got, [x.cpu() for x in tps.peak_stats_reference(g)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(4))
def test_kernel_column_major_tiebreak(cuda, case):
    g, want = list(tie_cases())[case]
    _, idx, _, _ = tps.peak_stats(torch.from_numpy(g).to(cuda))
    assert int(idx) == want


@pytest.mark.gpu
def test_kernel_is_deterministic(cuda):
    g = torch.randn((8, 2, 480, 640), device=cuda)
    a = tps.peak_stats(g)
    b = tps.peak_stats(g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
