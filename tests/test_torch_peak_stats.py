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

from nislam_torch.kernels import launch
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
    """``rows`` pins a block's range to whole rows, the last band ragged."""
    for b in (1, 2, 8, 16, 600):
        for h, w in ((1, 8), (20, 130), (360, 480), (480, 640), (1200, 1600)):
            for rows in (1, 7, 320, 600, 5000):
                s, chunk, unit = launch.block_ranges(b, h, w, rows)
                assert chunk * unit == min(rows, h) * w
                assert s == -(-h // min(rows, h)) and s * chunk * unit >= h * w > (s - 1) * chunk * unit


# Every response shape of the main path, a ragged one, one whose size is
# no multiple of 4, and a tiny one; batches from 1 to 16 and one past the cap.
GEOMETRY_SHAPES = [(360, 480), (480, 640), (300, 400), (1200, 1600), (20, 130), (17, 33), (1, 1)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows", [None, 1, 7, 600])
@pytest.mark.parametrize("h,w", GEOMETRY_SHAPES)
def test_block_ranges_cover_every_element_once(h, w, rows, aligned):
    n = h * w
    for b in (1, 2, 3, 8, 16, 600):
        s, chunk, unit = launch.block_ranges(b, h, w, rows, aligned=aligned)
        assert unit in (1, 4) and s >= 1 and chunk >= 1
        if unit == 4:  # the vector path: 16-byte loads from 16-byte boundaries
            assert aligned and n % 4 == 0
            assert all((k * chunk * unit * 4) % 16 == 0 for k in range(s))
        elif rows is None:
            assert not aligned or n % 4 != 0
        seen = np.zeros(n, np.int32)
        for k in range(s):
            lo, hi = k * chunk * unit, min(n, (k + 1) * chunk * unit)
            assert lo < hi  # no empty block
            seen[lo:hi] += 1
        assert (seen == 1).all()
        if rows is None:
            # about eight blocks per SM over the batch, one block per array at
            # least, one merge round per array at most, and never more
            # blocks than the data holds tiles
            assert b * s <= max(b, launch.TARGET_BLOCKS) and s <= launch.MERGE_WIDTH
            assert s <= -(-(n // unit) // launch.TILE)
            assert chunk % launch.TILE == 0 or s == 1
        else:
            assert chunk * unit == min(rows, h) * w


def test_block_ranges_at_the_path_shapes():
    """Blocks per response at the tracking, loop-search and HD shapes."""
    want = {(1, 360, 480): 43, (1, 480, 640): 75, (8, 360, 480): 43, (16, 480, 640): 38,
            (16, 300, 400): 30, (1, 1200, 1600): 235, (2, 1200, 1600): 235, (16, 1200, 1600): 59}
    got = {k: launch.block_ranges(*k)[0] for k in want}
    assert got == want
    with pytest.raises(ValueError):
        launch.block_ranges(1, 20, 130, rows=0)
    with pytest.raises(ValueError):
        launch.block_ranges(0, 20, 130)


def jax_tail(jx, stats, shape):
    """The tail of the JAX ``estimate_trans`` on its four statistics."""
    _, jnp, pk = jx
    h, w = shape
    peak, idx, s, ss = stats
    row = (idx // w).astype(jnp.float32)
    col = (idx % w).astype(jnp.float32)
    trans = jnp.stack([-(row - h // 2), -(col - w // 2)], axis=-1)
    return trans, pk.psr_from_stats(peak, s, ss, h * w)


def registration_cases(rng):
    for shape in [(3, 24, 32), (16, 128), (2, 3, 20, 130)]:
        yield rng.standard_normal(shape).astype(np.float32)
    for g, _ in tie_cases():
        yield g


@pytest.mark.parametrize("path", ["jnp", "pallas"])
@pytest.mark.parametrize("case", range(7))
def test_registration_stats_reference_matches_jax_tail(rng, jx, case, path):
    """``trans`` and ``idx`` equal, ``psr`` at rtol 1e-5: the same f32
    formula on sums taken in another order."""
    jax, jnp, pk = jx
    g = list(registration_cases(rng))[case]
    shape = g.shape[-2:]
    if path == "jnp":
        stats = pk.peak_stats(jnp.asarray(g), force="jnp")
    else:
        fn = pk._pallas_peak_stats_2d
        for _ in range(g.ndim - 2):
            fn = jax.vmap(fn)
        stats = interpret(jx, fn, g)
    want_trans, want_psr = jax_tail(jx, stats, shape)
    got = tps.registration_stats(torch.from_numpy(g), shape)
    assert len(got) == 6 and got[0].shape == g.shape[:-2] + (2,) and got[0].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_trans))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(stats[1]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_psr), rtol=1e-5)
    again = tps.registration_stats_reference(torch.from_numpy(g), shape)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # a CPU tensor takes the plain version
    assert all(torch.equal(a, b) for a, b in zip(got[2:], tps.peak_stats_reference(torch.from_numpy(g))))


def test_registration_stats_checks_the_shape():
    g = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError):
        tps.registration_stats(g, (6, 4))
    with pytest.raises(ValueError):
        tps.registration_stats(g, (4, 6), force="kernel")  # a CPU tensor cannot take the kernel
    trans, info = tps.registration_stats(g, (4, 6))[:2]
    # All ties: the first element in column-major order, (0, 0).
    assert trans.tolist() == [[2.0, 3.0]] * 2 and info.shape == (2,)


def test_workspace_is_kept_and_grows():
    """One zeroed buffer per (device, stream); a larger need replaces it
    with a larger zeroed one; ``drop`` forgets it."""
    ws = launch.Workspace()
    dev = torch.device("cpu")
    a = ws.get(dev, 0, 100)
    assert a.dtype == torch.int32 and a.numel() >= launch.COUNTERS + 100 and not a.any()
    assert ws.get(dev, 0, 200) is a  # room to spare: no new allocation
    assert ws.get(dev, 7, 100) is not a  # another stream, another buffer
    big = ws.get(dev, 0, a.numel())
    assert big is not a and big.numel() >= 2 * a.numel() and not big.any()
    assert ws.get(dev, 0, 100) is big
    ws.drop(dev, 0)
    assert ws.get(dev, 0, 100) is not big


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


def assert_fused_epilogue_exact(got, shape):
    """The kernel's ``trans`` and ``psr`` equal, bit for bit, the plain
    arithmetic (IEEE f32, on the CPU) on the kernel's own statistics."""
    trans, info, *stats = (t.cpu() for t in got)
    want_trans, want_psr = tps.registration_epilogue(*stats, shape)
    assert torch.equal(trans.view(torch.int32), want_trans.view(torch.int32))
    assert torch.equal(info.view(torch.int32), want_psr.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape", [(360, 480), (480, 640), (8, 360, 480), (8, 2, 480, 640), (8, 2, 300, 400),
              (1200, 1600), (20, 130), (3, 17, 33)],
)
def test_kernel_fused_outputs(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = torch.randn(shape, generator=gen, device=cuda)
    before = tps.peak_stats.launches
    got = tps.registration_stats(g, shape[-2:])
    assert tps.peak_stats.launches == before + 1
    assert got[0].shape == shape[:-2] + (2,) and got[1].shape == shape[:-2]
    assert_stats_equal(got[2:], [x.cpu() for x in tps.peak_stats_reference(g)])
    assert_fused_epilogue_exact(got, shape[-2:])


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(4))
def test_kernel_fused_outputs_on_ties(cuda, case):
    g, want = list(tie_cases())[case]
    got = tps.registration_stats(torch.from_numpy(g).to(cuda), g.shape)
    assert int(got[3]) == want
    assert_fused_epilogue_exact(got, g.shape)


@pytest.mark.gpu
def test_kernel_many_launches_reuse_the_workspace(cuda):
    """1200 back-to-back launches on one stream, alternating two shapes and
    two batch sizes (the second outgrows the first's workspace): every
    launch finds its counters at zero and reproduces the first results."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    inputs = [torch.randn(shape, generator=gen, device=cuda)
              for shape in ((360, 480), (8, 2, 480, 640), (2, 1200, 1600), (48, 1, 130))]
    first = [tps.registration_stats(g, g.shape[-2:]) for g in inputs]
    later = [tps.registration_stats(inputs[i % 4], inputs[i % 4].shape[-2:]) for i in range(1200)]
    torch.cuda.synchronize()
    for i, got in enumerate(later):
        assert all(torch.equal(a, b) for a, b in zip(got, first[i % 4])), i
    # one array per block: the workspace grows past its first size
    wide = torch.randn((6000, 4, 8), generator=gen, device=cuda)
    got, want = tps.peak_stats(wide), tps.peak_stats_reference(wide)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # 32 values per array, sums near zero: within 1e-5 of sum|x|
    assert bool(((got[2] - want[2]).abs() <= 1e-5 * wide.abs().sum(dim=(-2, -1))).all())
    assert all(torch.equal(a, b) for a, b in zip(tps.registration_stats(inputs[0], (360, 480)), first[0]))


@pytest.mark.gpu
def test_kernel_on_a_side_stream_and_unaligned_base(cuda):
    g = torch.randn((2, 480, 640), device=cuda)
    want = tps.peak_stats(g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = tps.peak_stats(g)
    side.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    flat = torch.randn(480 * 640 + 1, device=cuda)
    shifted = flat[1:].view(480, 640)  # base 4 bytes off a 16-byte boundary: the scalar path
    assert_stats_equal(tps.peak_stats(shifted), [x.cpu() for x in tps.peak_stats_reference(shifted)])
