"""PyTorch / CUDA port of the NI-SLAM engine (counterpart of ``nislam_tpu``).

Layout mirrors ``nislam_tpu``: ``ops/`` (FFT, warps, the ``peak_stats``
and ``sum_only`` kernel wrappers, KCC registration), ``core/`` (config,
SE(2), camera, map store, loop closure, pose graph, stitcher, calibration,
the engine), ``models/`` (registration, visual odometry, full SLAM),
``parallel/`` (the multi-sequence batch engine), ``io/`` (datasets, the
NISF reader, checkpoints, trajectories, plots), ``scripts/`` (pkbench),
``kernels/`` (nvcc build and ctypes loading) and ``csrc/`` (CUDA
sources).  Entry points: ``python -m nislam_torch`` (:mod:`nislam_torch.cli`),
``nislam_torch.core.slam.make_engine(config, device)``, the
``nislam_torch.models`` classes and
``nislam_torch.parallel.make_batch_engine(config, batch, device)``.  This
package never imports JAX.
"""
