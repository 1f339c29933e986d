"""Typed configuration for the PyTorch port, field for field the JAX
package's `vi_slam_tpu/utils/config.py`.

The port keeps its own copy so that it imports nothing of the JAX
package. `config_from_dict` rebuilds a config from the reference's
`dataclasses.asdict` output, so a test can hand both sides one config.

`ExtractorConfig.use_pallas_fast` is kept for parity of the field set but
selects nothing here: the port's extractor always runs the FAST-9 CUDA
kernel on a CUDA image and the plain PyTorch version on a CPU image
(`ops/fast_kernel.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Tuple


class Sensor(Enum):
    """Sensor modes (reference: `core/system.h:96-102` eSensor)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4


@dataclass(frozen=True)
class CameraConfig:
    model: str = "pinhole"  # "pinhole" | "kb8"
    width: int = 1241
    height: int = 376
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    dist: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0)
    bf: float = 386.1448  # baseline * fx (stereo), 0 for mono
    fps: float = 10.0
    th_depth: float = 35.0


@dataclass(frozen=True)
class ExtractorConfig:
    """ORB extractor knobs (reference: ORBextractor section of
    config/KITTI00-Stereo.yaml and fextractor.h:26-91)."""

    n_features: int = 2000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0  # iniThFAST
    fast_min_threshold: float = 7.0  # minThFAST
    cell_size: int = 32  # vilib grid-NMS cell (fast_cuda.cpp:88-99)
    max_candidates_per_level: int = 4096
    use_pallas_fast: bool = False


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor-matching thresholds (reference: fmatcher.cpp:313-315)."""

    th_low: int = 50
    th_high: int = 100
    nn_ratio: float = 0.9
    check_orientation: bool = True
    histo_bins: int = 30
    stereo_mutual: bool = False
    stereo_median_sweep: bool = True


@dataclass(frozen=True)
class TrackerConfig:
    search_radius: float = 15.0
    min_matches_motion: int = 20
    min_matches_local_map: int = 30
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 10
    kf_ref_ratio: float = 0.75  # insert KF if tracked < ratio * ref visible
    recently_lost_sec: float = 5.0
    pipeline_depth: int = 3
    atlas_enabled: bool = True
    atlas_lost_sec: float = 0.5
    max_timestamp_jump_sec: float = 3.0
    kf_point_budget: int = 384
    maintenance_every: int = 1
    mapping_every: int = 1
    local_ba_every: int = 1
    frontend: str = "orb"  # "orb" | "klt"
    klt_half: int = 5  # LK patch half-size (vilib patch 8x8 ~ half 4-5)
    klt_iters: int = 8  # IC iterations per pyramid level
    klt_levels: int = 5
    klt_max_residual: float = 25.0  # mean-abs photometric gate
    klt_min_tracks: int = 350
    klt_assoc_radius: float = 2.0
    klt_rescue_min: int = 60


@dataclass(frozen=True)
class BAConfig:
    pose_rounds: int = 4
    pose_iters_per_round: int = 10
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    max_local_kfs: int = 16
    max_fixed_kfs: int = 16
    max_local_points: int = 4096
    local_ba_iters: int = 10
    inertial_window: int = 10
    gba_iters: int = 10
    solver_dtype: str = "float32"
    use_smoother: bool = False
    smoother_window: int = 6
    smoother_vis: int = 96
    smoother_iters: int = 2
    mapping_fuse_window: int = 3


@dataclass(frozen=True)
class IMUConfig:
    """Noise densities / random walk (reference: Calib imu.h:74-126,
    ParseIMUParamFile tracking.cpp:1105)."""

    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    freq: float = 200.0
    T_bc: Optional[Tuple[float, ...]] = None
    gravity: float = 9.81


@dataclass(frozen=True)
class MapConfig:
    """Static capacities for the struct-of-arrays map (SURVEY §7.1)."""

    max_keyframes: int = 512
    max_points: int = 65536
    max_obs_per_point: int = 16
    covis_weight_min: int = 15  # covisibility edge threshold (keyframe.h)
    essential_weight_min: int = 100  # essential-graph edge threshold


@dataclass(frozen=True)
class PlaceConfig:
    """Vocabulary / place recognition (DBoW3 equivalents)."""

    vocab_k: int = 10  # branching factor
    vocab_levels: int = 4  # depth -> k^L leaf words (10^4 here)
    min_common_words_ratio: float = 0.8
    loop_consistency: int = 3


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for distributed global BA (SURVEY §2.4 item 3)."""

    data_axis: str = "dp"
    n_devices: int = 1


@dataclass(frozen=True)
class SystemConfig:
    sensor: Sensor = Sensor.STEREO
    camera: CameraConfig = field(default_factory=CameraConfig)
    extractor: ExtractorConfig = field(default_factory=ExtractorConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    imu: IMUConfig = field(default_factory=IMUConfig)
    map: MapConfig = field(default_factory=MapConfig)
    place: PlaceConfig = field(default_factory=PlaceConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def kitti00_mono() -> SystemConfig:
    """The monocular KITTI-00 preset: the default camera without a
    baseline."""
    return SystemConfig(sensor=Sensor.MONOCULAR, camera=CameraConfig(bf=0.0))


_SECTIONS = {
    "camera": CameraConfig, "extractor": ExtractorConfig,
    "matcher": MatcherConfig, "tracker": TrackerConfig, "ba": BAConfig,
    "imu": IMUConfig, "map": MapConfig, "place": PlaceConfig,
    "mesh": MeshConfig,
}


def config_from_dict(d: dict) -> SystemConfig:
    """Build a SystemConfig from a nested plain dict, such as
    `dataclasses.asdict` of the reference's config. Unknown keys raise."""

    def _build(cls, sub: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in sub.items():
            if k not in names:
                raise KeyError(f"unknown config key {cls.__name__}.{k}")
            if cls is SystemConfig and k in _SECTIONS:
                kw[k] = _build(_SECTIONS[k], v)
            elif cls is SystemConfig and k == "sensor":
                kw[k] = _sensor(v)
            elif isinstance(v, list):
                kw[k] = tuple(v)
            else:
                kw[k] = v
        return cls(**kw)

    return _build(SystemConfig, d)


def _sensor(v) -> Sensor:
    if isinstance(v, str):
        return Sensor[v]
    if isinstance(v, Enum):
        return Sensor[v.name]
    return Sensor(v)
