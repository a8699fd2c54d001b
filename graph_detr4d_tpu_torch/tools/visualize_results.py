"""BEV images of detection results (counterpart of
tools/misc/visualize_results.py; the reference draws with open3d / mpl,
both tools write a dependency-free BEV PNG).

    python -m graph_detr4d_tpu_torch.tools.visualize_results \\
        --results results.json --out-dir viz/

`results.json` is what tools/test.py --out writes. The drawing is the JAX
tool's numpy arithmetic (float32 corners and rotation, 64 samples an
edge), so its PNG files are byte-equal. Host-only: it reads a file and
needs no device.
"""

import argparse
import json
import os
import struct
import zlib

import numpy as np


def draw_bev(boxes, labels, scores, pc_range, size=640):
    """Rasterize rotated BEV rectangles into an RGB uint8 image."""
    img = np.zeros((size, size, 3), np.uint8)
    span = pc_range[3] - pc_range[0]

    def to_px(x, y):
        px = (x - pc_range[0]) / span * (size - 1)
        py = (y - pc_range[1]) / span * (size - 1)
        return px, py

    for box, label, score in zip(boxes, labels, scores):
        cx, cy, w, l, yaw = box[0], box[1], box[3], box[4], box[6]
        c, s = np.cos(yaw), np.sin(yaw)
        corners = np.array(
            [[w, l], [-w, l], [-w, -l], [w, -l]], np.float32
        ) / 2.0
        rot = np.array([[c, -s], [s, c]], np.float32)
        pts = corners @ rot.T + np.array([cx, cy])
        color = np.array(
            [
                int(64 + 191 * min(score, 1.0)),
                int(32 + (int(label) * 53) % 200),
                128,
            ],
            np.uint8,
        )
        # each edge sampled densely (no cv2 dependency)
        for i in range(4):
            a, b = pts[i], pts[(i + 1) % 4]
            for t in np.linspace(0.0, 1.0, 64):
                x, y = a * (1 - t) + b * t
                px, py = to_px(x, y)
                if 0 <= px < size and 0 <= py < size:
                    img[int(py), int(px)] = color
    return img


def save_png(path, img):
    """Minimal PNG writer (zlib + struct, no imaging dependency)."""
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    png += chunk(b"IDAT", zlib.compress(raw))
    png += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="graph_detr4d_tpu_torch.tools.visualize_results")
    p.add_argument("--results", required=True,
                   help="results json from tools/test.py --out")
    p.add_argument("--out-dir", default="viz")
    p.add_argument("--max-samples", type=int, default=20)
    p.add_argument("--pc-range", nargs=6, type=float,
                   default=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    os.makedirs(args.out_dir, exist_ok=True)
    items = results if isinstance(results, list) else results.get("results", [])
    for i, r in enumerate(items[: args.max_samples]):
        img = draw_bev(
            np.asarray(r["boxes_3d"], np.float32),
            np.asarray(r["labels_3d"], np.int32),
            np.asarray(r["scores_3d"], np.float32),
            args.pc_range,
        )
        out = os.path.join(args.out_dir, f"sample{i:04d}_bev.png")
        save_png(out, img)
        print(out)


if __name__ == "__main__":
    main()
