"""Config dataclasses of the SLAM engine and the YAML loaders.

Field-for-field copies of ``nislam_tpu.core.config`` (a test holds every
name and default equal, and :func:`load_config` equal to the JAX loader on
every file of ``configs/``), so the port runs without the JAX package and
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


def _validated(value: str, allowed: tuple, key: str) -> str:
    if value not in allowed:
        raise ValueError(f"{key}: {value!r} not in {allowed}")
    return value


def _read_yaml(path: str) -> dict:
    import yaml  # only the loaders need it

    with open(path) as f:
        return yaml.safe_load(f)


def load_camera_config(path: str) -> CameraConfig:
    """Camera YAML: ``image_size``, ``height``, ``accurate_height`` and the
    ``data`` lists of ``intrinsics``, ``distortion``, ``extrinsics``."""
    node = _read_yaml(path)
    k = node["intrinsics"]["data"]
    d = node["distortion"]["data"]
    e = node["extrinsics"]["data"]
    return CameraConfig(
        image_width=int(node["image_size"][0]),
        image_height=int(node["image_size"][1]),
        height=float(node["height"]),
        accurate_height=bool(node["accurate_height"]),
        intrinsics=(float(k[0]), float(k[1]), float(k[2]), float(k[3])),
        distortion=tuple(float(x) for x in d[:5]),
        extrinsics=tuple(float(x) for x in e[:9]),
    )


def load_config(path: str, *, load_camera: bool = True) -> SlamConfig:
    """Main YAML → :class:`SlamConfig`.  Unknown keys are ignored; missing
    keys take the dataclass defaults; the stitcher block is read under
    either spelling, ``map_sticther`` (the reference's) or ``map_stitcher``."""
    node = _read_yaml(path)

    ds = node.get("dataset", {})
    dataset = DatasetConfig(
        dataroot=ds.get("dataroot", ""),
        image_dir_name=ds.get("image_dir_name", ""),
        camera_file=ds.get("camera_config", ""),
    )

    cfn = node.get("correlation_flow", {})
    cf = CFConfig(
        width=int(cfn.get("width", 640)),
        height=int(cfn.get("height", 480)),
        lambda_=float(cfn.get("lambda", 0.1)),
        kernel=int(cfn.get("kernel", 0)),
        sigma=float(cfn.get("gaussian", {}).get("sigma", 0.2)),
        offset=float(cfn.get("polynomial", {}).get("offset", 0.1)),
        power=int(cfn.get("polynomial", {}).get("power", 3)),
        rotation_divisor=int(cfn.get("rotation_divisor", 720)),
        rotation_channel=int(cfn.get("rotation_channel", 480)),
        rotate_method=str(cfn.get("rotate_method", "fft")),
        polar_taps=_validated(
            str(cfn.get("polar_taps", "auto")), ("auto", "quad", "4tap"),
            "correlation_flow.polar_taps",
        ),
        half_polar=bool(cfn.get("half_polar", True)),
    )

    kfn = node.get("keyframe_selection", {})
    lr = kfn.get("lower_rotation_response_thr")
    ur = kfn.get("upper_rotation_response_thr")
    kfs = KeyframeSelectionConfig(
        max_distance=float(kfn.get("max_distance", 0.4)),
        max_angle=float(kfn.get("max_angle", 0.052359877)),
        lower_response_thr=float(kfn.get("lower_response_thr", 30.0)),
        upper_response_thr=float(kfn.get("upper_response_thr", 90.0)),
        lower_rotation_response_thr=None if lr is None else float(lr),
        upper_rotation_response_thr=None if ur is None else float(ur),
    )

    mpn = node.get("map", {})
    mp = MapConfig(
        grid_scale=float(mpn.get("grid_scale", 0.1)),
        keyframe_capacity=int(mpn.get("keyframe_capacity", 512)),
        edge_capacity=int(mpn.get("edge_capacity", 2048)),
        store_images=bool(mpn.get("store_images", True)),
        cache_filters=bool(mpn.get("cache_filters", True)),
        eviction=str(mpn.get("eviction", "ring")),
        bank_dtype=str(mpn.get("bank_dtype", "f32")),
    )

    lcn = node.get("loop_closure", {})
    lc = LoopClosureConfig(
        to_find_loop=bool(lcn.get("to_find_loop", True)),
        position_response_thr=float(lcn.get("position_response_thr", 60.0)),
        angle_response_thr=float(lcn.get("angle_response_thr", 60.0)),
        frame_gap_thr=int(lcn.get("frame_gap_thr", 100)),
        distance_thr=float(lcn.get("distance_thr", 5.0)),
        max_candidates=int(lcn.get("max_candidates", 8)),
        coarse_scale=int(lcn.get("coarse_scale", 1)),
        max_candidates_per_shard=int(lcn.get("max_candidates_per_shard", 0)),
        pending_capacity=int(lcn.get("pending_capacity", 32)),
    )

    msn = node.get("map_sticther", node.get("map_stitcher", {}))
    ms = MapStitcherConfig(
        stitch_map=bool(msn.get("stitch_map", True)),
        cell_size=int(msn.get("cell_size", 1000)),
        canvas_size=int(msn.get("canvas_size", 2048)),
        canvas_center=tuple(int(v) for v in msn.get("canvas_center", (0, 0))),
        online=bool(msn.get("online", False)),
    )

    opn = node.get("optimizer", {})
    opt = OptimizerConfig(
        max_iterations=int(opn.get("max_iterations", 100)),
        with_scale=bool(opn.get("with_scale", False)),
        inline=bool(opn.get("inline", False)),
    )

    svn = node.get("saving", {})
    sv = SavingConfig(
        saving_root=svn.get("saving_root", "./saving"),
        save_pose=bool(svn.get("save_pose", True)),
    )

    camera = CameraConfig(image_width=cf.width, image_height=cf.height)
    if load_camera and dataset.camera_file:
        camera = load_camera_config(dataset.camera_file)

    return SlamConfig(
        dataset=dataset, cf=cf, keyframe_selection=kfs, map=mp, loop_closure=lc,
        map_stitcher=ms, optimizer=opt, saving=sv, camera=camera,
        scan_unroll=int(node.get("scan_unroll", 1)),
    )
