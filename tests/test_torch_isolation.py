"""The PyTorch port and chip_smoke.py never import JAX or the JAX package.

The GPU machine that runs the port has no JAX, so an import of `jax`,
`jaxlib` or `vi_slam_tpu` anywhere in `vi_slam_tpu_torch/` or in
`chip_smoke.py` — even indirectly — would break it there.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "vi_slam_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "vi_slam_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


_CHILD = r'''
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "vi_slam_tpu")

def forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError(f"refused import of {name}")
        return None

preloaded = [m for m in sys.modules if forbidden(m)]
assert not preloaded, preloaded
sys.meta_path.insert(0, Refuse())
import vi_slam_tpu_torch
names = ["vi_slam_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(vi_slam_tpu_torch.__path__, "vi_slam_tpu_torch.")
]
for n in names:
    importlib.import_module(n)
import chip_smoke
loaded = sorted(m for m in sys.modules if forbidden(m))
assert not loaded, loaded
print(len(names))
'''


SLICE_3_MODULES = (
    "lie/sim3.py", "io/synthetic.py", "retrieval/vocabulary.py", "retrieval/database.py",
    "slam_map/covis.py", "loop/sim3_solver.py", "optim/sim3_opt.py", "optim/pose_graph.py",
    "optim/pnp.py", "optim/local_ba.py", "pipeline/steps.py", "pipeline/loop_closing.py",
    "pipeline/relocalization.py", "pipeline/stereo_vo.py", "utils/sampling.py",
    "utils/timing.py",
)


@pytest.mark.parametrize("module", SLICE_3_MODULES)
def test_loop_slice_modules_are_checked(module):
    """The loop-closing slice's modules are among the files checked above
    and in the import test below."""
    assert ROOT / "vi_slam_tpu_torch" / module in _port_files()


SLICE_4_MODULES = (
    "imu/preintegration.py", "optim/pose_inertial.py", "optim/inertial_init.py",
    "optim/vi_ba.py", "slam_map/atlas.py", "pipeline/vio.py",
)


@pytest.mark.parametrize("module", SLICE_4_MODULES)
def test_inertial_slice_modules_are_checked(module):
    """The atlas and inertial slice's modules are among the files checked
    above and in the import test below."""
    assert ROOT / "vi_slam_tpu_torch" / module in _port_files()


SLICE_5_MODULES = ("ops/klt.py", "ops/harris.py", "pipeline/klt_vo.py")


@pytest.mark.parametrize("module", SLICE_5_MODULES)
def test_klt_slice_modules_are_checked(module):
    """The KLT slice's modules are among the files checked above and in
    the import test below."""
    assert ROOT / "vi_slam_tpu_torch" / module in _port_files()


SLICE_6_MODULES = ("optim/smoother.py",)


@pytest.mark.parametrize("module", SLICE_6_MODULES)
def test_smoother_slice_modules_are_checked(module):
    """The fixed-lag smoother's module is among the files checked above and
    in the import test below."""
    assert ROOT / "vi_slam_tpu_torch" / module in _port_files()


SLICE_7_MODULES = ("geometry/two_view.py", "pipeline/mono_vo.py", "utils/config.py")


@pytest.mark.parametrize("module", SLICE_7_MODULES)
def test_mono_slice_modules_are_checked(module):
    """The monocular slice's modules (two-view initialization, MonoVO and
    the kitti00_mono preset) are among the files checked above and in
    the import test below."""
    assert ROOT / "vi_slam_tpu_torch" / module in _port_files()


def _no_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    """Every entry point defaults to the card and raises without one:
    make_stereo_inertial_vo, the KLT frontend (through either module's
    make_stereo_vo, and KltStereoVO itself), make_oracle_features, the BoW
    database and its allocation, and MonoVO (with the kitti00_mono
    preset)."""
    import dataclasses

    import numpy as np

    from vi_slam_tpu_torch.pipeline import klt_vo, stereo_vo
    from vi_slam_tpu_torch.pipeline.mono_vo import MonoVO
    from vi_slam_tpu_torch.pipeline.stereo_vo import make_oracle_features
    from vi_slam_tpu_torch.pipeline.vio import make_stereo_inertial_vo
    from vi_slam_tpu_torch.retrieval import database
    from vi_slam_tpu_torch.utils.config import SystemConfig, TrackerConfig, kitti00_mono

    _no_cuda(monkeypatch)
    klt = dataclasses.replace(SystemConfig(), tracker=TrackerConfig(frontend="klt"))
    calls = [
        lambda: make_stereo_inertial_vo(SystemConfig()),
        lambda: klt_vo.make_stereo_vo(klt),
        lambda: stereo_vo.make_stereo_vo(klt),
        lambda: klt_vo.KltStereoVO(klt),
        lambda: make_oracle_features(4, np.zeros((2, 2)), np.zeros(2), np.zeros(2),
                                     np.zeros((2, 8), np.uint32), np.zeros(2, np.int32)),
        lambda: database.KeyFrameDatabase(8, 16),
        lambda: database.allocate(8, 16),
        lambda: MonoVO(kitti00_mono()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_smoother_raises(monkeypatch):
    """The fixed-lag smoother is ported: use_smoother=True builds on
    device="cpu" with an empty window, and on the default device raises
    without a card, as every entry point does. (The name is the test's
    from before the smoother was ported, when use_smoother=True raised
    NotImplementedError.)"""
    import dataclasses

    from vi_slam_tpu_torch.optim import smoother
    from vi_slam_tpu_torch.pipeline.vio import make_stereo_inertial_vo
    from vi_slam_tpu_torch.utils.config import BAConfig, SystemConfig

    cfg = dataclasses.replace(SystemConfig(), ba=BAConfig(use_smoother=True))
    vo = make_stereo_inertial_vo(cfg, device="cpu")
    assert vo.smoother_count == 0 and isinstance(vo.smoother_win, smoother.SmootherWindow)
    assert vo.smoother_win.T_R.shape == (cfg.ba.smoother_window, 3, 3)
    assert vo.smoother_win.vis_xw.shape == (cfg.ba.smoother_window, cfg.ba.smoother_vis, 3)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        make_stereo_inertial_vo(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        smoother.allocate_window(6, 96)


def test_klt_stereo_inertial_raises():
    """The reference has no KLT stereo-inertial pipeline (its
    StereoInertialVO is a StereoVO): frontend "klt" raises
    NotImplementedError, before any device is touched."""
    import dataclasses

    from vi_slam_tpu_torch.pipeline.vio import make_stereo_inertial_vo
    from vi_slam_tpu_torch.utils.config import SystemConfig, TrackerConfig

    cfg = dataclasses.replace(SystemConfig(), tracker=TrackerConfig(frontend="klt"))
    with pytest.raises(NotImplementedError, match="ORB frontend only"):
        make_stereo_inertial_vo(cfg, device="cpu")


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 50
