"""The PyTorch generator against the numpy originals in
``nislam_torch.utils.synthetic``, on the same random draws."""

import numpy as np
import torch

from benchmarks.harness import synth, traffic
from nislam_torch.utils import synthetic


def test_world_equals_numpy_blur_of_the_same_noise():
    n, sigma = 256, 3.0
    noise = np.random.default_rng(42).standard_normal((n, n)).astype(np.float32)
    want = synthetic.make_world(n, sigma, seed=42)
    got = synth.blur_world(torch.from_numpy(noise), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_path_equals_numpy_path():
    for n, step in ((512, 8.0), (192, 100.0), (37, 3.0)):
        want = synthetic.heading_loop_path(n, step=step, start=(123.5, 77.25))
        assert synth.heading_loop_path(n, step, (123.5, 77.25)) == want


def test_views_equal_numpy_render():
    world = synthetic.make_world(512, 3.0, seed=3)
    poses = synthetic.heading_loop_path(40, step=5.0, start=(500.0, 10.0))
    want = synthetic.render_sequence(world, 48, 64, poses)
    got = synth.render(torch.from_numpy(world), 48, 64, torch.tensor(poses, dtype=torch.float64), batch=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_sensor_noise_equals_numpy_on_the_same_grain():
    frames = np.random.default_rng(5).random((12, 16, 20), dtype=np.float32)
    grain = np.random.default_rng(7).standard_normal(frames.shape).astype(np.float32)
    want = synthetic.add_sensor_noise(frames, seed=7)
    got = synth.sensor_noise(torch.from_numpy(frames), torch.from_numpy(grain)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_the_mix_fixes_the_content_and_the_seed_its_order():
    mix = {"name": "t", "model": "slam", "frames_per_sequence": 8, "world_seeds": [3, 4, 5], "chunk": 4,
           "world": 128, "texture_sigma": 3.0, "step_px": 3.0, "noise_sigma": 0.01, "illum_drift": 0.1}
    big = 2**31 + 12345
    a = traffic.make_sequences(mix, 24, 32, big, "cpu")
    b = traffic.make_sequences(mix, 24, 32, big, "cpu")
    orders = {tuple(traffic.make_sequences(mix, 24, 32, big + k, "cpu").order) for k in range(8)}
    c = traffic.make_sequences(mix, 24, 32, 7, "cpu")
    assert torch.equal(a.frames, b.frames) and a.order == b.order
    assert torch.equal(a.frames, c.frames)  # every seed the same work
    assert len(orders) > 1 and all(sorted(o) == [0, 1, 2] for o in orders)
    assert a.frames.shape == (3, 8, 24, 32)
    assert not torch.equal(a.frames[0], a.frames[1])
    assert float(a.frames.min()) >= 0.0 and float(a.frames.max()) <= 1.0
    d = traffic.make_sequences(mix, 24, 32, big, "cpu", world_seeds=[6, 7, 8])
    assert not torch.equal(a.frames, d.frames)
