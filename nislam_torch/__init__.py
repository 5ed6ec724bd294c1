"""PyTorch / CUDA port of the NI-SLAM engine (counterpart of ``nislam_tpu``).

Layout mirrors ``nislam_tpu``: ``ops/`` (FFT, warps, the ``peak_stats``
kernel wrapper, KCC registration), ``core/`` (config, SE(2), camera, map
store, loop closure, pose graph, stitcher, calibration, the engine),
``io/`` (datasets, the NISF reader, checkpoints, trajectories, plots),
``kernels/`` (nvcc build and ctypes loading) and ``csrc/`` (CUDA
sources).  Entry points: ``python -m nislam_torch`` (:mod:`nislam_torch.cli`)
and ``nislam_torch.core.slam.make_engine(config, device)``.  This package
never imports JAX.
"""
