"""Where the PyTorch port's ORB frontend differs from the JAX package's, on
one rendered KITTI-00-sized frame (the slice world's frame 0), on the CPU.

Prints one JSON line with:
  * pyramid: max |port - reference| per level (grey levels);
  * keypoints: per level, the number of keypoint slots whose (x, y) or
    validity differ;
  * descriptors: over valid keypoints the reference and the port share
    (same position and level), the number of descriptor bits that differ,
    the number of pair differences below 1e-4 in magnitude ("flat pairs"),
    and the largest |pair difference| (float64) among the differing bits.

    JAX_PLATFORMS=cpu python tools/torch_parity_report.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from vi_slam_tpu.features.extractor import OrbExtractor as RefExtractor  # noqa: E402
from vi_slam_tpu.ops import pyramid as ref_pyr  # noqa: E402
from vi_slam_tpu.utils.config import ExtractorConfig as RefExtractorConfig  # noqa: E402
from vi_slam_tpu_torch.features.extractor import OrbExtractor  # noqa: E402
from vi_slam_tpu_torch.io import synthetic  # noqa: E402
from vi_slam_tpu_torch.ops import orb  # noqa: E402
from vi_slam_tpu_torch.ops import pyramid as pyr_ops  # noqa: E402
from vi_slam_tpu_torch.utils.config import ExtractorConfig  # noqa: E402


def bits(words):
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    return ((w[..., None] >> np.arange(32)) & 1).reshape(*w.shape[:-1], 256)


def main():
    W, H = chip_smoke.W, chip_smoke.H
    world = synthetic.make_billboard_world(n_frames=1, n_boards=4000, seed=11, speed=1.0)
    left = chip_smoke.render_frames(world, 1)[0][0].astype(np.uint8).astype(np.float32)

    ref_levels = [np.asarray(x) for x in jax.jit(ref_pyr.build_pyramid, static_argnums=(1, 2))(
        jnp.asarray(left), 8, 1.2)]
    ext = OrbExtractor(ExtractorConfig(n_features=2000), H, W)
    port_levels = [x.numpy() for x in pyr_ops.build_pyramid(
        torch.from_numpy(left), 8, 1.2, ext.pyramid_weights())]
    pyr = [float(np.abs(a - b).max()) for a, b in zip(ref_levels, port_levels)]

    rext = RefExtractor(RefExtractorConfig(n_features=2000), H, W)
    rf, _ = rext._fn_atlas(jnp.asarray(left))
    rf = [np.asarray(x) for x in rf]
    pf, atlas = ext.extract(torch.from_numpy(left))
    pf = [x.numpy() for x in pf]
    kp_diff = []
    for lv in range(8):
        sl = rf[1] == lv
        differ = np.any(rf[0][sl] != pf[0][sl], axis=1) | (rf[5][sl] != pf[5][sl])
        kp_diff.append(int(differ.sum()))
    same = rf[5] & pf[5] & np.all(rf[0] == pf[0], axis=1) & (rf[1] == pf[1])

    # float64 pair differences of the port's inputs, to locate flat pairs
    lv = pf[1]
    offs = np.asarray(ext.row_offsets)[lv]
    xy = np.round(np.stack([pf[0][:, 0] / ext.scales[lv],
                            pf[0][:, 1] / ext.scales[lv] + offs], -1)).astype(np.float32)
    bl = pyr_ops.gaussian_blur(atlas).double()
    patches = orb.extract_patches(bl, torch.from_numpy(xy)).reshape(len(xy), -1)
    d = (patches @ torch.from_numpy(orb.stencil_matrix()).double()).reshape(len(xy), 32, 256)
    d = d[torch.arange(len(xy)), orb.angle_bins(torch.from_numpy(pf[2]))].numpy()
    flip = (bits(rf[4].view(np.int32)) != bits(pf[4]))[same]
    flat = (np.abs(d) < 1e-4)[same]
    print(json.dumps({
        "image": f"{W}x{H} slice world frame 0",
        "pyramid_max_abs_diff": pyr,
        "keypoint_slots_differing_per_level": kp_diff,
        "shared_valid_keypoints": int(same.sum()),
        "descriptor_bits_compared": int(flip.size),
        "descriptor_bits_differing": int(flip.sum()),
        "flat_pairs": int(flat.sum()),
        "differing_bits_outside_flat_pairs": int((flip & ~flat).sum()),
        "max_abs_pair_diff_at_differing_bits": float(np.abs(d[same][flip]).max()) if flip.any() else 0.0,
    }))


if __name__ == "__main__":
    main()
