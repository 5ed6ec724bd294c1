"""The port's ops and small core modules against the JAX package, on the CPU.

Inputs come from a numpy seed and go through both the JAX function and
its torch counterpart.  Tolerances: float32 transforms in two FFT
libraries agree to ~1e-6 relative (rtol 1e-5); the rotation and feature
chains to 1e-4 of the largest magnitude (the JAX engine's quad-packed
polar table differs from the 4-tap one by ~1e-6); integer results
(shifts, degrees, slots, the 180° choice) exactly.

PSRs to ``PSR_RTOL`` = 5e-4: the polynomial kernel cubes a correlation
with a large DC term and the filter solve divides by it, so FFT roundoff
reaches the response.  Measured on the loop-mode synthetic pair against a
float64 numpy chain: the JAX PSR is 1.3e-5 off, the torch PSR 9.2e-5, and
the two differ by up to 2.6e-4 across these cases.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nislam_torch.core.camera as tcam
import nislam_torch.core.loop_closure as tlc
import nislam_torch.core.map_store as tms
import nislam_torch.core.se2 as tse2
import nislam_torch.ops.fft as tfft
import nislam_torch.ops.registration as treg
import nislam_torch.ops.warp as twarp
import nislam_tpu.core.camera as jcam
import nislam_tpu.core.loop_closure as jlc
import nislam_tpu.core.map_store as jms
import nislam_tpu.core.se2 as jse2
import nislam_tpu.ops.fft as jfft
import nislam_tpu.ops.registration as jreg
import nislam_tpu.ops.warp as jwarp
from nislam_tpu.core.config import CameraConfig, CFConfig, LoopClosureConfig, MapConfig
from nislam_tpu.utils.synthetic import make_world, render_frame

# The suite runs in parallel worker processes: keep torch from taking every core.
torch.set_num_threads(2)

H, W = 96, 128
PSR_RTOL = 5e-4
CF = CFConfig(width=W, height=H, rotation_divisor=360, rotation_channel=96)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close_to_max(a, b, rtol=1e-4):
    a, b = N(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


def cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def ops():
    return treg.make_cf_ops(CF), jreg.make_cf_ops(CF)


@pytest.fixture(scope="module")
def textures():
    world = make_world(512, 3.0, seed=3)
    a = render_frame(world, H, W, 200.0, 210.0, 0.0)
    b = render_frame(world, H, W, 203.0, 208.0, 0.3)  # shifted and rotated
    c = render_frame(world, H, W, 201.0, 211.0, 0.3 + np.pi)  # and turned around
    return a, b, c


# --- fft ---------------------------------------------------------------


def test_fft_functions_match(rng):
    x = rng.standard_normal((2, 12, 10)).astype(np.float32)
    f = cplx(rng, (2, 12, 6))  # not Hermitian: c2r must ignore DC/Nyquist imag
    pairs = [
        (tfft.rfft2(T(x)), jfft.rfft2(jnp.asarray(x))),
        (tfft.irfft2(T(f), (12, 10)), jfft.irfft2(jnp.asarray(f), (12, 10))),
        (tfft.irfft2(T(np.abs(f)), (12, 10)), jfft.irfft2(jnp.abs(jnp.asarray(f)), (12, 10))),
        (tfft.rfft_last(T(x)), jfft.rfft_last(jnp.asarray(x))),
        (tfft.irfft_last(T(f), 10), jfft.irfft_last(jnp.asarray(f), 10)),
        (tfft.irfft_last(T(f), 11), jfft.irfft_last(jnp.asarray(f), 11)),
        (tfft.rfft_ax2(T(x)), jfft.rfft_ax2(jnp.asarray(x))),
        (tfft.irfft_ax2(T(f.transpose(0, 2, 1)), 10), jfft.irfft_ax2(jnp.asarray(f.transpose(0, 2, 1)), 10)),
        (tfft.rfft2_from_last_spectrum(T(f)), jfft.rfft2_from_last_spectrum(jnp.asarray(f))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pair_views_and_bf16_upcast(rng):
    f = cplx(rng, (4, 5))
    pair = tfft.c2r(T(f))
    np.testing.assert_array_equal(N(pair), np.asarray(jfft.c2r(jnp.asarray(f))))
    np.testing.assert_array_equal(N(tfft.r2c(pair)), f)
    bf = pair.to(torch.bfloat16)
    up = tfft.r2c(bf)
    assert up.dtype == torch.complex64
    want = jfft.r2c(jnp.asarray(N(bf.float())).astype(jnp.bfloat16))
    np.testing.assert_array_equal(N(up), np.asarray(want))


# --- warp --------------------------------------------------------------


@pytest.mark.parametrize("wrap", [False, True])
def test_bilinear_sample_matches(rng, wrap):
    img = rng.random((2, 10, 12)).astype(np.float32)
    x = (rng.random((7, 9)) * 16 - 2).astype(np.float32)
    y = (rng.random((7, 9)) * 14 - 2).astype(np.float32)
    got = twarp.bilinear_sample(T(img), T(x), T(y), wrap=wrap)
    want = jwarp.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), wrap=wrap)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_polar_resample_matches(rng):
    power = rng.standard_normal((3, H, W)).astype(np.float32)
    idx, wgt = jwarp.polar_tap_constants(H, W, 360, 96, fold_dc=False)
    got = twarp.polar_resample(T(power), T(idx), T(wgt))
    want = jwarp.polar_resample(jnp.asarray(power), jnp.asarray(idx), jnp.asarray(wgt))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("deg", [0.0, 17.3, -64.0, 135.5, -179.0])
def test_rotations_match(textures, deg):
    img = textures[0]
    d = np.float32(deg)
    close_to_max(
        twarp.rotate_wrap_fft_spectrum(T(img), T(d)),
        jwarp.rotate_wrap_fft_spectrum(jnp.asarray(img), jnp.asarray(d)),
    )
    close_to_max(
        twarp.rotate_wrap_fft(T(img), T(d)),
        jwarp.rotate_wrap_fft(jnp.asarray(img), jnp.asarray(d)),
    )
    close_to_max(
        twarp.rotate_wrap(T(img), T(d)), jwarp.rotate_wrap(jnp.asarray(img), jnp.asarray(d))
    )


def test_batched_rotation_broadcasts(textures):
    img = textures[0][None]
    degs = np.array([10.0, -100.0, 170.0], np.float32)
    close_to_max(
        twarp.rotate_wrap_fft_spectrum(T(img), T(degs)),
        jwarp.rotate_wrap_fft_spectrum(jnp.asarray(img), jnp.asarray(degs)),
    )


# --- registration ------------------------------------------------------


def test_cf_ops_tables(ops):
    t, j = ops
    np.testing.assert_array_equal(N(t.target_fft), np.asarray(j.target_fft))
    np.testing.assert_array_equal(N(t.target_rot_fft), np.asarray(j.target_rot_fft))
    idx, wgt = jwarp.polar_tap_constants(H, W, 360, 96, fold_dc=False)
    np.testing.assert_array_equal(N(t.polar_idx), idx[:180])
    np.testing.assert_array_equal(N(t.polar_w), wgt[:180])
    assert (t.half_psr_a, t.half_psr_b) == (j.half_psr_a, j.half_psr_b)


def test_compute_intermedium_matches(ops, textures):
    t, j = ops
    img = np.stack(textures[:2])
    tf, tp = treg.compute_intermedium(T(img), t)
    jf, jp = jreg.compute_intermedium(jnp.asarray(img), j)
    close_to_max(tf, jf)
    close_to_max(tp, jp)


def test_small_functions_match(rng):
    x = rng.standard_normal((2, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        N(treg.remove_zero_component(T(x))), np.asarray(jreg.remove_zero_component(jnp.asarray(x)))
    )
    g = rng.random((2, 16, 20)).astype(np.float32)
    peak = g.reshape(2, -1).max(-1)
    np.testing.assert_allclose(
        N(treg.psr(T(g), T(peak))), np.asarray(jreg.psr(jnp.asarray(g), jnp.asarray(peak))), rtol=1e-5
    )
    deg = np.array([-540.0, -180.0, -0.5, 179.9, 180.0, 725.0], np.float32)
    np.testing.assert_array_equal(
        N(treg.normalize_degree(T(deg))), np.asarray(jreg.normalize_degree(jnp.asarray(deg)))
    )


@pytest.mark.parametrize("kernel", [0, 1])
def test_kernel_spectrum_and_filter(rng, kernel):
    cfg = CFConfig(width=20, height=16, kernel=kernel, sigma=0.5)
    zf = np.fft.rfft2(rng.random((2, 16, 20))).astype(np.complex64)
    xf = np.fft.rfft2(rng.random((2, 16, 20))).astype(np.complex64)
    close_to_max(
        treg._kernel_spectrum(T(xf), T(zf), (16, 20), cfg),
        jreg._kernel_spectrum(jnp.asarray(xf), jnp.asarray(zf), (16, 20), cfg),
    )
    tgt = jfft.impulse_spectrum(16, 20)
    close_to_max(
        treg.keyframe_filter(T(zf), T(np.asarray(tgt)), (16, 20), cfg),
        jreg.keyframe_filter(jnp.asarray(zf), tgt, (16, 20), cfg),
    )


def _features(ops_pair, imgs):
    t, j = ops_pair
    return treg.compute_intermedium(T(imgs), t), jreg.compute_intermedium(jnp.asarray(imgs), j)


@pytest.mark.parametrize("source", ["synthetic", "random"])
def test_estimate_trans_matches(ops, textures, rng, source):
    imgs = np.stack(textures[:2]) if source == "synthetic" else rng.random((2, H, W)).astype(np.float32)
    (tf, _), (jf, _) = _features(ops, imgs)
    tt, tpsr = treg.estimate_trans(tf[0], tf[1], tfft.r2c(ops[0].target_fft), (H, W), CF)
    jt, jpsr = jreg.estimate_trans(jf[0], jf[1], jfft.r2c(ops[1].target_fft), (H, W), CF)
    np.testing.assert_array_equal(N(tt), np.asarray(jt))
    np.testing.assert_allclose(float(tpsr), float(jpsr), rtol=PSR_RTOL)


@pytest.mark.parametrize("large_rotation", [False, True])
@pytest.mark.parametrize("method", ["fft", "bilinear"])
@pytest.mark.parametrize("source", ["synthetic", "random"])
def test_compute_pose_matches(textures, rng, large_rotation, method, source):
    cfg = CFConfig(width=W, height=H, rotation_divisor=360, rotation_channel=96, rotate_method=method)
    pair = (treg.make_cf_ops(cfg), jreg.make_cf_ops(cfg))
    if source == "synthetic":
        imgs = np.stack([textures[0], textures[2] if large_rotation else textures[1]])
    else:
        imgs = rng.random((2, H, W)).astype(np.float32)
    (tf, tp), (jf, jp) = _features(pair, imgs)
    tfilt = treg.compute_keyframe_filters(tf[0], tp[0], pair[0])
    jfilt = jreg.compute_keyframe_filters(jf[0], jp[0], pair[1])
    for filters in (None, "cached"):
        tpose, tinfo = treg.compute_pose(
            tf[0], T(imgs[1]), tp[0], tp[1], pair[0], large_rotation=large_rotation,
            filters=tfilt if filters else None,
        )
        jpose, jinfo = jreg.compute_pose(
            jf[0], jnp.asarray(imgs[1]), jp[0], jp[1], pair[1], large_rotation=large_rotation,
            filters=jfilt if filters else None,
        )
        # Shifts, degree and the 180° choice exactly; the PSRs to PSR_RTOL.
        np.testing.assert_array_equal(N(tpose), np.asarray(jpose))
        np.testing.assert_allclose(N(tinfo), np.asarray(jinfo), rtol=PSR_RTOL)


def test_compute_pose_batched_loop_mode(ops, textures):
    imgs = np.stack([textures[0], textures[1], textures[2]])
    (tf, tp), (jf, jp) = _features(ops, imgs)
    tpose, tinfo = treg.compute_pose(
        tf, T(imgs[2])[None], tp, tp[2][None], ops[0], large_rotation=True
    )
    jpose, jinfo = jax.jit(jreg.compute_pose, static_argnames="large_rotation")(
        jf, jnp.asarray(imgs[2])[None], jp, jp[2][None], ops[1], large_rotation=True
    )
    np.testing.assert_array_equal(N(tpose), np.asarray(jpose))
    np.testing.assert_allclose(N(tinfo), np.asarray(jinfo), rtol=PSR_RTOL)


# --- se2, camera -------------------------------------------------------


def test_se2_matches(rng):
    p1 = (rng.standard_normal((5, 3)) * [3, 3, 4]).astype(np.float32)
    p2 = (rng.standard_normal((5, 3)) * [3, 3, 4]).astype(np.float32)
    for tf_, jf_ in [(tse2.relative_pose, jse2.relative_pose), (tse2.absolute_pose, jse2.absolute_pose)]:
        np.testing.assert_allclose(N(tf_(T(p1), T(p2))), np.asarray(jf_(jnp.asarray(p1), jnp.asarray(p2))), atol=1e-5)
    np.testing.assert_allclose(
        N(tse2.normalize_angle(T(p1[:, 2]))), np.asarray(jse2.normalize_angle(jnp.asarray(p1[:, 2]))), atol=1e-6
    )
    np.testing.assert_allclose(
        N(tse2.rotation2d(T(p1[:, 2]))), np.asarray(jse2.rotation2d(jnp.asarray(p1[:, 2]))), atol=1e-6
    )


@pytest.mark.parametrize("distortion", [(0.0,) * 5, (-0.15, 0.03, 0.001, 0.0005, 0.0)])
def test_camera_matches(rng, distortion):
    cfg = CameraConfig(
        image_width=W, image_height=H, height=1.3, intrinsics=(110.0, 60.0, 105.0, 50.0),
        distortion=distortion, extrinsics=(0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0),
    )
    t, j = tcam.make_camera_ops(cfg), jcam.make_camera_ops(cfg)
    assert t.identity_remap == j.identity_remap
    img = rng.random((H, W)).astype(np.float32)
    np.testing.assert_allclose(N(t.undistort(T(img))), np.asarray(j.undistort(jnp.asarray(img))), atol=1e-6)
    pose = (rng.standard_normal((4, 3)) * [20, 20, 2]).astype(np.float32)
    for name in [
        "image_plane_to_camera", "camera_to_image_plane", "camera_to_robot", "robot_to_camera",
        "image_plane_to_robot", "robot_to_image_plane", "center_to_principal", "principal_to_center",
    ]:
        got = getattr(t, name)(T(pose))
        want = getattr(j, name)(jnp.asarray(pose))
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=name)
    assert float(t.length_of_pixel()) == pytest.approx(float(j.length_of_pixel()), rel=1e-6)


# --- map store, loop closure -------------------------------------------


def _small_cf():
    return CFConfig(width=16, height=12, rotation_divisor=20, rotation_channel=8)


@pytest.mark.parametrize("eviction,bank_dtype", [("ring", "f32"), ("drop", "bf16")])
def test_map_store_sequence_matches(rng, eviction, bank_dtype):
    cf = _small_cf()
    mc = MapConfig(grid_scale=0.5, keyframe_capacity=4, edge_capacity=5, eviction=eviction,
                   bank_dtype=bank_dtype)
    tb, jb = tms.make_keyframe_bank(cf, mc, torch.device("cpu")), jms.make_keyframe_bank(cf, mc)
    te, je = tms.make_edge_store(mc, torch.device("cpu")), jms.make_edge_store(mc)
    ring = eviction == "ring"
    for i in range(9):
        fft = cplx(rng, (12, 9))
        pol = cplx(rng, (10, 5))
        img = rng.random((12, 16)).astype(np.float32)
        pose = (rng.standard_normal(3) * 2).astype(np.float32)
        tb, ts, tst, tev = tms.add_keyframe(
            tb, fft=T(fft), polar_fft=T(pol), filt=T(fft), filt_polar=T(pol), image=T(img),
            pose=T(pose), frame_id=T(np.int32(i)), distance=T(np.float32(0.7 * i)),
            grid_scale=0.5, enabled=i != 3, evict=ring, protect_slot=T(np.int32(2)),
        )
        jb, js, jst, jev = jms.add_keyframe(
            jb, fft=jnp.asarray(fft), polar_fft=jnp.asarray(pol), filt=jnp.asarray(fft),
            filt_polar=jnp.asarray(pol), image=jnp.asarray(img), pose=jnp.asarray(pose),
            frame_id=jnp.int32(i), distance=jnp.float32(0.7 * i), grid_scale=0.5,
            enabled=jnp.asarray(i != 3), evict=ring, protect_slot=jnp.int32(2),
        )
        assert (int(ts), bool(tst), int(tev)) == (int(js), bool(jst), int(jev))
        te = tms.invalidate_edges(te, tev)
        je = jms.invalidate_edges(je, jev)
        for etype in (tms.EDGE_KCC, tms.EDGE_LOOP if i % 3 == 0 else tms.EDGE_KCC):
            rel = rng.standard_normal(3).astype(np.float32)
            te = tms.add_edge(te, from_slot=T(np.int32(i % 4)), to_slot=ts, T=T(rel),
                              edge_type=etype, enabled=tst)
            je = jms.add_edge(je, from_slot=jnp.int32(i % 4), to_slot=js, T=jnp.asarray(rel),
                              edge_type=etype, enabled=jst)
    for name in ["fft", "polar_fft", "filt", "filt_polar", "images", "poses", "grid_xy",
                 "frame_ids", "distances", "count", "overflow", "evict_cursor"]:
        got, want = getattr(tb, name), np.asarray(getattr(jb, name))
        if got.dtype == torch.bfloat16:
            got, want = got.float(), want.astype(np.float32)
        np.testing.assert_array_equal(N(got), want, err_msg=name)
    for name in ["from_slot", "to_slot", "T", "info", "types", "alive", "count", "overflow"]:
        np.testing.assert_array_equal(N(getattr(te, name)), np.asarray(getattr(je, name)), err_msg=name)
    prior = np.array([0.3, -0.4, 0.0], np.float32)
    np.testing.assert_array_equal(
        N(tms.frames_in_neighborhood(tb, T(prior), 0.5)),
        np.asarray(jms.frames_in_neighborhood(jb, jnp.asarray(prior), 0.5)),
    )


def test_find_loop_closure_matches(ops, textures):
    """A bank of views around one spot; the search picks the same slot,
    pose and response as JAX, also with every eligible score tied."""
    world = make_world(512, 3.0, seed=3)
    views = [render_frame(world, H, W, 200.0 + 2 * i, 210.0 - i, 0.2 * i) for i in range(10)]
    imgs = np.stack(views).astype(np.float32)
    (tf, tp), (jf, jp) = _features(ops, imgs)
    mc = MapConfig(grid_scale=0.5, keyframe_capacity=16, edge_capacity=8)
    tb, jb = tms.make_keyframe_bank(CF, mc, torch.device("cpu")), jms.make_keyframe_bank(CF, mc)
    j_insert = jax.jit(lambda b, *a: jms.add_keyframe(
        b, fft=a[0], polar_fft=a[1], filt=a[2], filt_polar=a[3], image=a[4], pose=a[5],
        frame_id=a[6], distance=a[7], grid_scale=0.5, enabled=True).bank)
    j_search = jax.jit(jlc.find_loop_closure, static_argnums=(7, 8))
    j_batched = jax.jit(jlc._batched_search, static_argnums=(5, 6))
    for i in range(9):
        tfi, tfp = treg.compute_keyframe_filters(tf[i], tp[i], ops[0])
        jfi, jfp = jreg.compute_keyframe_filters(jf[i], jp[i], ops[1])
        pose = np.array([0.01 * i, -0.02 * i, 0.2 * i], np.float32)
        tb = tms.add_keyframe(tb, fft=tf[i], polar_fft=tp[i], filt=tfi, filt_polar=tfp, image=T(imgs[i]),
                              pose=T(pose), frame_id=T(np.int32(i)), distance=T(np.float32(i)),
                              grid_scale=0.5, enabled=True).bank
        jb = j_insert(jb, jf[i], jp[i], jfi, jfp, jnp.asarray(imgs[i]), jnp.asarray(pose),
                      jnp.int32(i), jnp.float32(i))
    lcfg = LoopClosureConfig(position_response_thr=5.0, angle_response_thr=5.0, frame_gap_thr=2,
                             distance_thr=1.0, max_candidates=4)
    prior = np.array([0.05, -0.05, 0.0], np.float32)
    t = tlc.find_loop_closure(tb, T(imgs[9]), tp[9], T(np.int32(12)), T(np.float32(12.0)), T(prior),
                              ops[0], lcfg, 0.5)
    j = j_search(jb, jnp.asarray(imgs[9]), jp[9], jnp.int32(12), jnp.float32(12.0),
                              jnp.asarray(prior), ops[1], lcfg, 0.5)
    assert (bool(t.found), int(t.loop_slot), int(t.eligible_count)) == (
        bool(j.found), int(j.loop_slot), int(j.eligible_count))
    np.testing.assert_array_equal(N(t.relative_pose), np.asarray(j.relative_pose))
    np.testing.assert_allclose(N(t.response), np.asarray(j.response), rtol=PSR_RTOL)
    eligible = np.array([True, False, True, True, False, True, True, False, True] + [False] * 7)
    t2 = tlc._batched_search(tb, T(imgs[9]), tp[9], T(eligible), ops[0], 3, lcfg)
    j2 = j_batched(jb, jnp.asarray(imgs[9]), jp[9], jnp.asarray(eligible), ops[1], 3, lcfg)
    assert int(t2.loop_slot) == int(j2.loop_slot) and bool(t2.found) == bool(j2.found)
    np.testing.assert_allclose(N(t2.response), np.asarray(j2.response), rtol=PSR_RTOL)


def test_unported_paths_raise(ops):
    with pytest.raises(NotImplementedError):
        tlc.find_loop_closure_all()
    lcfg = LoopClosureConfig(coarse_scale=2)
    bank = tms.make_keyframe_bank(CF, MapConfig(keyframe_capacity=4), torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        tlc._batched_search(bank, torch.zeros(H, W), None, torch.ones(4, dtype=torch.bool), ops[0], 2, lcfg)
