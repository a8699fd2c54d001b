"""Browse dataset samples: each camera image with the projected GT box
centres marked (counterpart of tools/misc/browse_dataset.py; reference
tools/misc/browse_dataset.py).

    python -m graph_detr4d_tpu_torch.tools.browse_dataset \\
        --ann-file infos.pkl --out-dir browse/

Reads a nuScenes-layout infos pkl with data/nuscenes.py's
NuScenesSweepDataset and decodes with data/pipeline.py::load_image; the
marks are the JAX tool's numpy arithmetic, so the PNG files are
byte-equal. Host-only: it needs no device.
"""

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.browse_dataset")
    p.add_argument("--ann-file", required=True)
    p.add_argument("--out-dir", default="browse")
    p.add_argument("--max-samples", type=int, default=5)
    return p.parse_args(argv)


def main(argv=None):
    from ..data.nuscenes import NuScenesSweepDataset
    from ..data.pipeline import load_image
    from .visualize_results import save_png

    args = parse_args(argv)
    ds = NuScenesSweepDataset(args.ann_file, max_gt=128)
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(min(args.max_samples, len(ds))):
        s = ds.sample(i)
        gt = s["gt_bboxes"][s["gt_valid"] > 0]
        centers = np.concatenate([gt[:, :3], np.ones((len(gt), 1))], axis=1)
        for ci, (path, l2i) in enumerate(zip(s["image_paths"], s["lidar2img"])):
            img = load_image(path).astype(np.float32)
            proj = centers @ np.asarray(l2i).T
            z = np.maximum(proj[:, 2:3], 1e-5)
            uv = proj[:, :2] / z
            vis = ((proj[:, 2] > 0.1)
                   & (uv[:, 0] >= 0) & (uv[:, 0] < img.shape[1])
                   & (uv[:, 1] >= 0) & (uv[:, 1] < img.shape[0]))
            out = img.copy()
            for u, v in uv[vis]:
                u, v = int(u), int(v)
                out[max(v - 4, 0): v + 4, max(u - 4, 0): u + 4] = [255, 0, 0]
            dst = os.path.join(args.out_dir, f"sample{i:04d}_cam{ci}.png")
            save_png(dst, out.astype(np.uint8))
            print(dst, f"({int(vis.sum())} centers in view)")


if __name__ == "__main__":
    main()
