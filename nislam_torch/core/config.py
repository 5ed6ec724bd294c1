"""Config dataclasses of the SLAM engine.

Field-for-field copies of ``nislam_tpu.core.config`` (a test holds every
name and default equal), so the port runs without the JAX package and
either package's config object drives either engine.  The fields that only
steer TPU code paths (``CFConfig.polar_taps``, ``SlamConfig.scan_unroll``,
``LoopClosureConfig.max_candidates_per_shard``) are carried for that
compatibility and read by nothing here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    dataroot: str = ""
    image_dir_name: str = ""
    camera_file: str = ""


@dataclasses.dataclass(frozen=True)
class CFConfig:
    """KCC parameters; ``kernel`` 0 = polynomial, 1 = gaussian;
    ``rotate_method`` "fft" (three Fourier shears) or "bilinear";
    ``half_polar`` registers rotation on the angles [0, π) only."""

    width: int = 640
    height: int = 480
    lambda_: float = 0.1
    kernel: int = 0
    sigma: float = 0.2
    offset: float = 0.1
    power: int = 3
    rotation_divisor: int = 720
    rotation_channel: int = 480
    rotate_method: str = "fft"
    half_polar: bool = True
    polar_taps: str = "auto"

    @property
    def half_polar_active(self) -> bool:
        return self.half_polar and self.rotation_divisor % 2 == 0

    @property
    def polar_shape(self) -> Tuple[int, int]:
        """(rows, cols) of the polar map the engine registers."""
        d = self.rotation_divisor
        return (d // 2 if self.half_polar_active else d, self.rotation_channel)


@dataclasses.dataclass(frozen=True)
class KeyframeSelectionConfig:
    """Keyframe band; the rotation band defaults to the translation band."""

    max_distance: float = 0.4
    max_angle: float = 0.052359877
    lower_response_thr: float = 30.0
    upper_response_thr: float = 90.0
    lower_rotation_response_thr: float | None = None
    upper_rotation_response_thr: float | None = None

    @property
    def lower_rot(self) -> float:
        v = self.lower_rotation_response_thr
        return self.lower_response_thr if v is None else v

    @property
    def upper_rot(self) -> float:
        v = self.upper_rotation_response_thr
        return self.upper_response_thr if v is None else v


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Bank and edge capacities; ``eviction`` "ring" or "drop";
    ``bank_dtype`` "f32" or "bf16" for the four spectral bank tensors."""

    grid_scale: float = 0.1
    keyframe_capacity: int = 512
    edge_capacity: int = 2048
    store_images: bool = True
    eviction: str = "ring"
    cache_filters: bool = True
    bank_dtype: str = "f32"


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    to_find_loop: bool = True
    position_response_thr: float = 60.0
    angle_response_thr: float = 60.0
    frame_gap_thr: int = 100
    distance_thr: float = 5.0
    max_candidates: int = 8
    max_candidates_per_shard: int = 0
    pending_capacity: int = 32
    coarse_scale: int = 1


@dataclasses.dataclass(frozen=True)
class MapStitcherConfig:
    stitch_map: bool = True
    cell_size: int = 1000
    canvas_size: int = 2048
    canvas_center: tuple = (0, 0)
    online: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    max_iterations: int = 100
    with_scale: bool = False
    inline: bool = False


@dataclasses.dataclass(frozen=True)
class SavingConfig:
    saving_root: str = "./saving"
    save_pose: bool = True


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """``intrinsics = (fx, cx, fy, cy)``; ``distortion = (k1, k2, p1, p2,
    k3)``; ``extrinsics`` row-major 3×3; ``height`` above ground (m)."""

    image_width: int = 640
    image_height: int = 480
    height: float = 1.0
    accurate_height: bool = True
    intrinsics: Tuple[float, float, float, float] = (500.0, 320.0, 500.0, 240.0)
    distortion: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    extrinsics: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    dataset: DatasetConfig = DatasetConfig()
    cf: CFConfig = CFConfig()
    keyframe_selection: KeyframeSelectionConfig = KeyframeSelectionConfig()
    map: MapConfig = MapConfig()
    loop_closure: LoopClosureConfig = LoopClosureConfig()
    map_stitcher: MapStitcherConfig = MapStitcherConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    saving: SavingConfig = SavingConfig()
    camera: CameraConfig = CameraConfig()
    scan_unroll: int = 1


def derive_response_thresholds(
    width: int, height: int, rotation_divisor: int, rotation_channel: int
) -> dict:
    """PSR thresholds scaled from the reference's 640×480 / 720×480 anchors
    (tracking 30/90, loop 60/60) by the square root of the image area
    (translation) or of the polar grid (rotation)."""
    s_img = (width * height) ** 0.5 / (640 * 480) ** 0.5
    s_rot = (rotation_divisor * rotation_channel) ** 0.5 / (720 * 480) ** 0.5
    return {
        "lower_response_thr": round(30.0 * s_img, 2),
        "upper_response_thr": round(90.0 * s_img, 2),
        "lower_rotation_response_thr": round(30.0 * s_rot, 2),
        "upper_rotation_response_thr": round(90.0 * s_rot, 2),
        "position_response_thr": round(60.0 * s_img, 2),
        "angle_response_thr": round(60.0 * s_rot, 2),
    }
