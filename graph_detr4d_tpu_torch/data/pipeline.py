"""Image pipeline: decode -> resize(-crop-flip) -> normalize -> pad
(counterpart of graph_detr4d_tpu/data/pipeline.py, numpy on the host,
the same random draws in the same order, so one seed gives the same
batch in both packages).

Each transform that changes image geometry rewrites `lidar2img` so the
on-device projection stays consistent. Reference transforms
(datasets/pipelines/transform_3d.py):

  * NormalizeMultiviewImage (:80-113): mean/std, RGB;
  * PadMultiViewImage (:28-77): pad to /32;
  * ResizeCropFlipImage (:362-468): resize, crop, optional horizontal
    flip, a 3x3 ida matrix left-composed into lidar2img;
  * GlobalRotScaleTransImage (:471-551): BEV yaw rotation and scaling of
    lidar2img and the GT boxes (reverse_angle=True);
  * PhotoMetricDistortionMultiViewImage (:687-784): brightness, contrast,
    saturation and hue jitter.

IMG_MEAN/STD are the detr3d/detr4d defaults (configs/...12e.py:13-14,
to_rgb=True); BGR configs pass `img_norm=(mean, std, bgr)` from the
ModelConfig. `build_batch` returns numpy arrays; the caller moves them to
the device (parallel/transfer.py::cast_for_transfer first).
"""

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _resize_img(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    try:
        import cv2

        return cv2.resize(
            img, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR
        )
    except ImportError:  # pragma: no cover
        from PIL import Image

        # PIL fallback only handles uint8; clip so out-of-range floats
        # (photometric output is unclipped, like the reference) don't wrap
        return np.asarray(
            Image.fromarray(
                np.clip(img, 0, 255).astype(np.uint8)
            ).resize((out_hw[1], out_hw[0]), Image.BILINEAR)
        ).astype(img.dtype)


def load_image(path: str, file_client=None) -> np.ndarray:
    """RGB uint8 HWC. `file_client` (data/storage.py FileClient) routes the
    read through the configured backend / path remap (petrel-FileClient
    parity, loading.py:42,81-82); None = plain local read."""
    if file_client is not None:
        import io

        data = file_client.get(path)
        try:
            import cv2

            buf = np.frombuffer(data, np.uint8)
            bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            return bgr[..., ::-1].copy()
        except ImportError:  # pragma: no cover
            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    try:
        import cv2

        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        return bgr[..., ::-1].copy()
    except ImportError:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


_DECODE_POOL = None
_DECODE_POOL_SIZE = None


def _decode_pool():
    """Shared JPEG-decode thread pool for the python batch path —
    cv2.imdecode/imread release the GIL, so threads give real decode
    parallelism. The reference gets this from workers_per_gpu=4
    DataLoader processes (SURVEY §3.1); here one pool decodes the 12
    camera views of a sample concurrently, deterministically (map keeps
    order; load_image consumes no rng). GRD4D_DECODE_THREADS=0 disables
    (sequential). The pool is keyed on the parsed thread count: changing
    the env mid-process rebuilds it (the old pool drains its in-flight
    work and is garbage-collected; callers only ever hold it through
    pool.map, which completes before return)."""
    global _DECODE_POOL, _DECODE_POOL_SIZE
    n = int(os.environ.get("GRD4D_DECODE_THREADS", "8"))
    if n <= 1:
        return None
    if _DECODE_POOL is None or _DECODE_POOL_SIZE != n:
        from concurrent.futures import ThreadPoolExecutor

        if _DECODE_POOL is not None:
            _DECODE_POOL.shutdown(wait=False)
        _DECODE_POOL = ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="grd4d-decode"
        )
        _DECODE_POOL_SIZE = n
    return _DECODE_POOL


def shutdown_decode_pool():
    """Stop the decode pool's threads (a CLI's main calls this on exit);
    the next decode starts a new pool."""
    global _DECODE_POOL, _DECODE_POOL_SIZE
    if _DECODE_POOL is not None:
        _DECODE_POOL.shutdown(wait=True)
        _DECODE_POOL = _DECODE_POOL_SIZE = None


def load_images_threaded(paths, file_client=None):
    pool = _decode_pool()
    if pool is None:
        return [load_image(p, file_client) for p in paths]
    return list(pool.map(lambda p: load_image(p, file_client), paths))


def map_cameras(fn, *per_camera):
    """[fn(*args) for each camera's args], on the decode pool's threads
    (numpy and cv2 release the GIL), in camera order. fn draws nothing
    from the batch's RandomState: its draws are made before, in the
    order the sequential loop makes them."""
    pool = _decode_pool()
    if pool is None:
        return [fn(*a) for a in zip(*per_camera)]
    return list(pool.map(fn, *per_camera))


@dataclass
class IdaAugParams:
    """One sampled image-domain augmentation (resize/crop/flip)."""

    resize: float
    crop: Tuple[int, int, int, int]  # (x1, y1, x2, y2) in resized coords
    flip: bool

    def ida_mat(self) -> np.ndarray:
        """3x3 matrix mapping original pixel coords -> augmented coords."""
        m = np.eye(3)
        m[0, 0] = m[1, 1] = self.resize
        m[0, 2] -= self.crop[0]
        m[1, 2] -= self.crop[1]
        if self.flip:
            w = self.crop[2] - self.crop[0]
            f = np.array([[-1.0, 0, w - 1], [0, 1.0, 0], [0, 0, 1.0]])
            m = f @ m
        return m


def sample_ida_params(
    rng: np.random.RandomState,
    src_hw: Tuple[int, int],
    final_hw: Tuple[int, int],
    resize_lim: Tuple[float, float] = (0.94, 1.25),
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0),
    rand_flip: bool = True,
    training: bool = True,
) -> IdaAugParams:
    """ida_aug_conf sampling (transform_3d.py:414-449; config :130-138).

    The reference's resize_lim multiplies final_w/src_w, so the resized
    image always covers final_dim and the crop stays in-bounds."""
    H, W = src_hw
    fH, fW = final_hw
    base = fW / W
    if training:
        resize = base * rng.uniform(*resize_lim)
        newW, newH = int(W * resize), int(H * resize)
        crop_h = (
            int((1 - rng.uniform(*bot_pct_lim)) * newH) - fH
        )
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        flip = bool(rand_flip and rng.rand() < 0.5)
    else:
        resize = base * np.mean(resize_lim)
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - np.mean(bot_pct_lim)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        flip = False
    crop_h = max(0, crop_h)
    crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
    return IdaAugParams(resize=resize, crop=crop, flip=flip)


def apply_ida(
    img: np.ndarray, l2i: np.ndarray, p: IdaAugParams
) -> Tuple[np.ndarray, np.ndarray]:
    """Resize/crop/flip one image and left-compose ida into lidar2img."""
    H, W = img.shape[:2]
    newH, newW = int(H * p.resize), int(W * p.resize)
    img = _resize_img(img, (newH, newW))
    x1, y1, x2, y2 = p.crop
    # pad if the crop exceeds the resized image (can happen by 1px rounding)
    ph, pw = max(0, y2 - newH), max(0, x2 - newW)
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
    img = img[y1:y2, x1:x2]
    if p.flip:
        img = img[:, ::-1]
    # fold the 3x3 pixel-domain ida into the 4x4 projection: the image rows
    # (0, 1) are numerators u*z, v*z and row 2 is z, so the pixel translation
    # multiplies the z row (NOT the homogeneous column)
    m3 = p.ida_mat()
    ida4 = np.eye(4, dtype=np.float64)
    ida4[:2, :2] = m3[:2, :2]
    ida4[:2, 2] = m3[:2, 2]
    return np.ascontiguousarray(img), (ida4 @ l2i).astype(np.float32)


def load_maps(map_filename: str):
    """BEV map masks of the segmentation variant (LoadMapsFromFiles,
    pipelines/loading.py:10-25). They feed PETR-seg's lane head, which the
    port does not run yet (ROADMAP Queue 1 item 5), so a sample that
    names a map raises."""
    raise NotImplementedError(
        f"sample has map_filename {map_filename!r}: BEV map masks feed the "
        "PETR-seg head (models/petr_seg.py::maps_to_patches), which "
        "graph_detr4d_tpu_torch does not port yet (ROADMAP Queue 1 item 5)"
    )


def normalize_image(
    img: np.ndarray,
    mean: np.ndarray = IMG_MEAN,
    std: np.ndarray = IMG_STD,
    bgr: bool = False,
) -> np.ndarray:
    """(img - mean) / std; `bgr=True` first reverses the channel order
    (images load as RGB here; the reference loads BGR and to_rgb=False
    keeps it, so mean/std are given in BGR order for those configs)."""
    if bgr:
        img = img[..., ::-1]
    return (img.astype(np.float32) - np.asarray(mean, np.float32)) / (
        np.asarray(std, np.float32)
    )


def pad_to_divisor(img: np.ndarray, divisor: int = 32) -> np.ndarray:
    H, W = img.shape[:2]
    ph = (divisor - H % divisor) % divisor
    pw = (divisor - W % divisor) % divisor
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
    return img


def global_rot_scale_trans(
    l2i: np.ndarray,
    gt_bboxes: np.ndarray,
    rng: np.random.RandomState,
    rot_range=(-0.3925, 0.3925),
    scale_range=(0.95, 1.05),
) -> Tuple[np.ndarray, np.ndarray]:
    """BEV rotation + scale on calibration and boxes
    (transform_3d.py:471-551, reverse_angle=True):
      points rotate by +a <-> lidar2img right-multiplied by R(-a)^T;
      boxes rotate by -a on yaw (reverse_angle) and centers by R."""
    a = rng.uniform(*rot_range)
    s = rng.uniform(*scale_range)
    ca, sa = np.cos(a), np.sin(a)
    R = np.array(
        [[ca, -sa, 0, 0], [sa, ca, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    )
    # calibration: new_l2i = l2i @ inv(world_transform); world transform is
    # rotate-by-a then scale-by-s
    inv = np.diag([1 / s, 1 / s, 1 / s, 1.0]) @ R.T
    l2i = (l2i @ inv[None]).astype(np.float32)

    out = gt_bboxes.copy()
    xyz = out[..., :3] @ R[:3, :3].T
    out[..., :3] = xyz * s
    out[..., 3:6] *= s
    # centers rotate by R(+a); in the stored (mmdet3d-info) yaw
    # convention — devkit yaw = -yaw_info - pi/2, submission.py:100 —
    # that means yaw DECREASES by a (the reference's reverse_angle=True
    # boxes.rotate(-a) does yaw += -a, transform_3d.py:505-508)
    out[..., 6] -= a
    if out.shape[-1] > 7:
        out[..., 7:9] = out[..., 7:9] @ R[:2, :2].T * s
    return l2i, out


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Float HSV, OpenCV convention (mmcv.bgr2hsv on float32): H in
    degrees [0, 360), S in [0, 1], V in the input scale."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = img.max(-1)
    mn = img.min(-1)
    c = v - mn
    safe_c = np.where(c == 0, 1.0, c)
    h = np.where(
        v == r,
        (g - b) / safe_c,
        np.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c),
    )
    h = (h * 60.0) % 360.0
    h = np.where(c == 0, 0.0, h)
    safe_v = np.where(v == 0, 1.0, v)
    s = np.where(v == 0, 0.0, c / safe_v)
    return np.stack([h, s, v], -1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = (h % 360.0) / 60.0
    i = np.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], -1)


def photometric_params(rng: np.random.RandomState) -> tuple:
    """The random draws of one photometric_distortion call, in its order:
    (brightness delta, contrast before HSV, saturation scale, hue shift,
    contrast after HSV, channel permutation), None where a step does not
    fire. They do not depend on the image, so a caller may draw every
    camera's first and apply them in parallel."""
    bright = rng.uniform(-32, 32) if rng.randint(2) else None
    mode = rng.randint(2)
    first = rng.uniform(0.5, 1.5) if mode == 1 and rng.randint(2) else None
    sat = rng.uniform(0.5, 1.5) if rng.randint(2) else None
    hue = rng.uniform(-18, 18) if rng.randint(2) else None
    last = rng.uniform(0.5, 1.5) if mode == 0 and rng.randint(2) else None
    perm = rng.permutation(3) if rng.randint(2) else None
    return bright, first, sat, hue, last, perm


def apply_photometric(img: np.ndarray, params: tuple) -> np.ndarray:
    """photometric_distortion with its draws given (photometric_params)."""
    bright, first, sat, hue, last, perm = params
    img = img.astype(np.float32)
    if bright is not None:
        img = img + bright
    if first is not None:
        img = img * first
    hsv = _rgb_to_hsv(img)
    if sat is not None:  # saturation scale on the S channel
        hsv[..., 1] *= sat
    if hue is not None:  # hue rotation in degrees
        hsv[..., 0] += hue
        hsv[..., 0][hsv[..., 0] > 360] -= 360
        hsv[..., 0][hsv[..., 0] < 0] += 360
    img = _hsv_to_rgb(hsv)
    if last is not None:
        img = img * last
    if perm is not None:
        img = img[..., perm]
    return img


def photometric_distortion(
    img: np.ndarray, rng: np.random.RandomState
) -> np.ndarray:
    """Brightness/contrast/saturation/hue jitter + random channel swap
    (PhotoMetricDistortionMultiViewImage, transform_3d.py:687-784): each
    step fires with prob 0.5; contrast runs second (mode 0) or second to
    last (mode 1); saturation/hue operate in true float HSV (mmcv
    bgr2hsv/hsv2bgr :746-760 — hue rotation in degrees with 360 wrap);
    the last step permutes the color channels (:770-772). Like the
    reference, the output is NOT clipped to [0, 255] — normalization
    consumes it as float.

    Channel-order nuance: the reference jitters mmcv-loaded BGR arrays;
    here images load as RGB, so the hue rotation acts on RGB-interpreted
    HSV (a hue reflection of the reference's distribution). Brightness/
    contrast/saturation are channel-order invariant and the final random
    channel swap further washes the difference out; train-aug
    distribution only, no checkpoint-parity impact."""
    return apply_photometric(img, photometric_params(rng))


class AlbuMultiview3D:
    """Albumentations adapter applied per camera view
    (AlbuMultiview3D, transform_3d.py:553-685). Construct with a list of
    albumentations transform dicts ({'type': 'Blur', 'p': 0.5}, ...);
    raises a clear error if albumentations is not installed (it is an
    optional extra here, matching the reference's soft dependency)."""

    def __init__(self, transforms):
        try:
            import albumentations
            from albumentations import Compose
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "AlbuMultiview3D requires the optional 'albumentations' "
                "package"
            ) from e

        def build(t):
            t = dict(t)
            cls = getattr(albumentations, t.pop("type"))
            if "transforms" in t:
                t["transforms"] = [build(x) for x in t["transforms"]]
            return cls(**t)

        self.aug = Compose([build(t) for t in transforms])

    def __call__(self, imgs):
        return [self.aug(image=img)["image"] for img in imgs]


def scale_aware_resize(
    imgs: Sequence[np.ndarray],
    lidar2img: np.ndarray,  # (N, 4, 4)
    intrinsics: np.ndarray,  # (N, 4, 4)
    resize_factor: float,
    scale_depth_by_focal_lengths_factor: float = 500.0,
):
    """Scale-aware resize (RandomResizeMultiViewImage_SimpleDA/_range,
    transform_3d.py:880-1035): resize images by one global factor, derive
    per-camera `depth_factors` from the resized inverse intrinsics'
    pixel size, and rewrite lidar2img = S @ L @ D.

    Quirk preserved from the reference (:938-941, :1026): the depth-factor
    matrix applied to EVERY camera's lidar2img is camera 0's (the
    `depth_factors_mat[0]` in the zip-comprehension).

    Returns (resized imgs, new lidar2img (N,4,4), depth_factors (N,),
    ida_mat (4,4)).
    """
    N = lidar2img.shape[0]
    h, w = imgs[0].shape[:2]
    th = int(np.around(h * resize_factor))
    tw = int(np.around(w * resize_factor))
    out_imgs = [_resize_img(im, (th, tw)) for im in imgs]

    S = np.eye(4)
    S[0, 0] = S[1, 1] = resize_factor
    cam2img = [S @ intrinsics[i] for i in range(N)]
    inv_c = [np.linalg.inv(c) for c in cam2img]
    depth_factors = np.asarray(
        [
            1.0
            / (
                np.linalg.norm(
                    np.stack([ic[0, 0], ic[1, 1]])
                )
                * scale_depth_by_focal_lengths_factor
            )
            for ic in inv_c
        ],
        np.float32,
    )
    D0 = np.eye(4)
    D0[0, 0] = D0[1, 1] = D0[2, 2] = depth_factors[0]
    new_l2i = np.asarray(
        [S @ lidar2img[i] @ D0 for i in range(N)], np.float32
    )
    ida_mat = np.eye(4, dtype=np.float32)
    ida_mat[0, 0] = ida_mat[1, 1] = resize_factor
    return out_imgs, new_l2i, depth_factors, ida_mat


def random_scale_multiview(
    imgs: Sequence[np.ndarray],
    lidar2img: np.ndarray,  # (N, 4, 4)
    rand_scale: float,
):
    """Pure-2D random image scale (RandomScaleImageMultiViewImage,
    transform_3d.py:838-878): resize every view by `rand_scale` and
    left-multiply lidar2img with the pixel scale — geometry (and GT)
    untouched. Returns (imgs, new_l2i)."""
    h, w = imgs[0].shape[:2]
    th, tw = int(h * rand_scale), int(w * rand_scale)
    out_imgs = [_resize_img(im, (th, tw)) for im in imgs]
    S = np.eye(4)
    S[0, 0] = S[1, 1] = rand_scale
    new_l2i = np.asarray(
        [S @ l for l in lidar2img], np.float32
    )
    return out_imgs, new_l2i


def random_resize_depth_scaled(
    imgs: Sequence[np.ndarray],
    lidar2img: np.ndarray,  # (N, 4, 4)
    gt_bboxes: np.ndarray,  # (G, >=3) centers in cols 0:3
    target_hw,  # (y, x) target size, aspect kept via min factor
):
    """Depth-scaled resize + GT rescale (RandomResizeImageMultiViewImage +
    ScaleAnnotations3D, transform_3d.py:786-833): lidar2img becomes
    S @ L @ diag(r, r, r, 1) and box centers divide by r, so the world
    shrinks with the image and projections stay consistent.

    Returns (imgs, new_l2i, new_gt_bboxes, resize_factor)."""
    h, w = imgs[0].shape[:2]
    r = min(target_hw[1] / w, target_hw[0] / h)
    th, tw = int(np.around(h * r)), int(np.around(w * r))
    out_imgs = [_resize_img(im, (th, tw)) for im in imgs]
    S = np.eye(4)
    S[0, 0] = S[1, 1] = r
    D = np.eye(4)
    D[0, 0] = D[1, 1] = D[2, 2] = r
    new_l2i = np.asarray([S @ l @ D for l in lidar2img], np.float32)
    gt = np.array(gt_bboxes, np.float32, copy=True)
    if gt.size:
        gt[:, :3] = gt[:, :3] / r
    return out_imgs, new_l2i, gt, r


def build_batch(
    samples: Sequence[dict],
    final_hw: Tuple[int, int],
    *,
    training: bool = False,
    rng: Optional[np.random.RandomState] = None,
    src_hw: Tuple[int, int] = (900, 1600),
    use_native: bool = False,
    aug=None,  # TrainConfig-like with .photometric/.ida_aug/.rot_aug
    img_norm: Optional[Tuple] = None,  # (mean, std, bgr) from ModelConfig
    # ModelConfig.device_normalize: ship RAW pixels (uint8 when the
    # pipeline preserves them; float after photometric) and let
    # detector.extract_feats apply (x - mean)/std on device. The BGR
    # channel reversal still happens HERE (a view, free); mean/std stay
    # unused on host.
    device_normalize: bool = False,
    # TTA: extra ida-resize multipliers; images become an
    # (A, B, N, H, W, 3) stack (copy 0 = base eval ida), decoded ONCE
    tta_resize_mults: Optional[Sequence[float]] = None,
) -> dict:
    """Assemble a fixed-shape batch dict from dataset samples (images
    loaded from disk, one shared ida per sample like the reference).

    use_native=True routes image loading through the C++ loader
    (graph_detr4d_tpu/native): multithreaded JPEG decode + fused
    resize/crop/flip/normalize outside the GIL — eval AND training
    (photometric distortion then runs post-resize on the fused output;
    see the branch comment). Samples hit by the multi-scale random
    resize fall back to the python path; TTA is python-path only."""
    rng = rng or np.random.RandomState(0)
    mean, std, bgr = (
        img_norm if img_norm is not None else (IMG_MEAN, IMG_STD, False)
    )
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if device_normalize:
        # raw zero-padding is not normalized zero-padding: require /32
        # network dims so pad_to_divisor is a no-op (true for every
        # shipped config; same argument as the PETR padding mask)
        assert final_hw[0] % 32 == 0 and final_hw[1] % 32 == 0, (
            f"device_normalize requires /32 img_size, got {final_hw}"
        )

    def _host_norm(img):
        if device_normalize:
            return img[..., ::-1] if bgr else img
        return normalize_image(img, mean, std, bgr)
    # aug switches default to the flagship 'rotcropaug' behavior; the
    # reference's aug/rotaug variants flip these per config
    use_photo = training and (aug is None or aug.photometric)
    use_ida = aug is None or aug.ida_aug
    use_rot = training and (aug is None or aug.rot_aug)
    images, l2is = [], []
    gtb, gtl, gtv = [], [], []
    maps, intrs, ida_scales = [], [], []
    extra_mults = [m for m in (tta_resize_mults or ()) if m != 1.0]
    extra_images = [[] for _ in extra_mults]
    extra_l2is = [[] for _ in extra_mults]
    if extra_mults:
        assert not training and not use_native, (
            "tta_resize_mults is an eval-only python-path feature"
        )
    if use_native:
        from ..native import available

        use_native = available()
    for s in samples:
        bboxes = s["gt_bboxes"]
        # multi-scale training: pick the per-sample random resize target
        # up front so the ida crop statistics see the true source size
        ms_target = None
        eff_src = src_hw
        if (
            training
            and aug is not None
            and getattr(aug, "resize_scales", None)
        ):
            ms_target = aug.resize_scales[
                rng.randint(len(aug.resize_scales))
            ]
            r = min(ms_target[1] / src_hw[1], ms_target[0] / src_hw[0])
            eff_src = (
                int(np.around(src_hw[0] * r)),
                int(np.around(src_hw[1] * r)),
            )
        # ida_aug off -> deterministic eval-style resize (no random
        # crop/flip) even in training
        p = sample_ida_params(
            rng, eff_src, final_hw, training=training and use_ida
        )

        def _tta_ida(mult):
            # perturb the eval resize and recenter the crop; each copy
            # carries its own composed ida @ lidar2img so aug_forward
            # samples every copy with matching calibration
            r = p.resize * mult
            newW, newH = int(eff_src[1] * r), int(eff_src[0] * r)
            fH, fW = final_hw
            cw = int(max(0, newW - fW) / 2)
            ch = max(0, newH - fH)
            return IdaAugParams(
                resize=r, crop=(cw, ch, cw + fW, ch + fH), flip=False
            )
        # native C++ loader: eval always; training too (the reference's
        # hot path is 12 jpegs/sample through 4 DataLoader workers,
        # loading.py:66-188) — except when the per-sample multi-scale
        # random resize fired (random_resize_depth_scaled also rescales
        # l2i/boxes; that sample falls back to the python path)
        if use_native and (not training or ms_target is None):
            from ..native import load_images

            if training and use_photo:
                # TRAIN path: fused C++ decode+resize/crop/flip first,
                # float-HSV photometric on the RESIZED image after. The
                # reference orders photometric BEFORE resize
                # (transform_3d.py:687) — pointwise jitter and bilinear
                # resize commute up to resampling noise, and jittering
                # final_dim pixels instead of the 900x1600 source is
                # cheaper; train-aug distribution only, no eval/parity
                # impact. Output is float raw-range pixels, so
                # device_normalize ships float here (same contract as
                # the python train path).
                raws = load_images(
                    list(s["image_paths"]),
                    resize=p.resize,
                    crop_xy=(p.crop[0], p.crop[1]),
                    out_hw=final_hw,
                    flip=p.flip,
                    raw_uint8=True,
                )
                photo = [photometric_params(rng) for _ in raws]
                imgs = map_cameras(
                    lambda im, ph: _host_norm(apply_photometric(im, ph)),
                    list(raws), photo)
            elif device_normalize:
                # raw-uint8 output mode: ship raw pixels, normalize on
                # device; only the BGR channel reversal happens here
                # (a view, free) — same contract as the python path
                imgs = load_images(
                    list(s["image_paths"]),
                    resize=p.resize,
                    crop_xy=(p.crop[0], p.crop[1]),
                    out_hw=final_hw,
                    flip=p.flip,
                    raw_uint8=True,
                )
                if bgr:
                    imgs = [im[..., ::-1] for im in imgs]
            else:
                # the C++ loader normalizes in decoded (RGB) order; BGR
                # configs normalize with channel-reversed mean/std then
                # flip the normalized output — identical to flip-first
                imgs = load_images(
                    list(s["image_paths"]),
                    resize=p.resize,
                    crop_xy=(p.crop[0], p.crop[1]),
                    out_hw=final_hw,
                    flip=p.flip,
                    mean=tuple(mean[::-1] if bgr else mean),
                    std=tuple(std[::-1] if bgr else std),
                )
                if bgr:
                    imgs = [im[..., ::-1] for im in imgs]
            ida4 = np.eye(4, dtype=np.float64)
            m3 = p.ida_mat()
            ida4[:2, :2] = m3[:2, :2]
            ida4[:2, 2] = m3[:2, 2]
            cams = [pad_to_divisor(im) for im in imgs]
            mats = [
                (ida4 @ l2i).astype(np.float32)
                for l2i in s["lidar2img"]
            ]
        else:
            # multi-scale: one random depth-scaled resize per sample
            # (RandomResizeImageMultiViewImage + ScaleAnnotations3D);
            # ida then brings every view to the static network size
            cams, mats = [], []
            imgs_raw = load_images_threaded(s["image_paths"])
            l2is_raw = list(s["lidar2img"])
            if ms_target is not None:
                imgs_raw, l2is_raw, bboxes, _ = random_resize_depth_scaled(
                    imgs_raw, np.asarray(l2is_raw), bboxes, ms_target
                )
            # the photometric draws of every camera first, in the order
            # the per-camera loop of the JAX pipeline makes them; the
            # cameras' work then runs in parallel
            photo = [photometric_params(rng) if use_photo else None
                     for _ in imgs_raw]

            def one_camera(img, l2i, ph, p=p):
                if ph is not None:
                    img = apply_photometric(img, ph)
                img_a, m = apply_ida(img, l2i, p)
                return pad_to_divisor(_host_norm(img_a)), m

            for img_a, m in map_cameras(one_camera, imgs_raw, l2is_raw, photo):
                cams.append(img_a)
                mats.append(m)
            # extra TTA copies reuse the already-decoded images (no
            # repeated JPEG I/O per multiplier); each copy keeps its OWN
            # composed ida @ lidar2img so the head samples every copy
            # with calibration that matches its pixels
            for mi, mult in enumerate(extra_mults):
                copies = map_cameras(
                    lambda img, l2i, ph, pm=_tta_ida(mult):
                        one_camera(img, l2i, ph, pm),
                    imgs_raw, l2is_raw, [None] * len(imgs_raw))
                extra_images[mi].append(np.stack([c for c, _ in copies]))
                extra_l2is[mi].append(np.asarray([m for _, m in copies]))
        mats = np.asarray(mats)
        if use_rot:
            mats, bboxes = global_rot_scale_trans(mats, bboxes, rng)
        images.append(np.stack(cams))
        l2is.append(mats)
        gtb.append(bboxes)
        gtl.append(s["gt_labels"])
        gtv.append(s["gt_valid"])
        if "map_filename" in s:
            maps.append(load_maps(s["map_filename"])[1])
        if "intrinsics" in s:
            intr = np.asarray(s["intrinsics"], np.float32)
            intrs.append(intr)
            # camera-aware aug_scale, the reference's exact quirk:
            # sqrt(ida[0,0]^2 + ida[0,0]^2) = sqrt(2)*|ida00|
            # (detr3d_head_pe_camaware.py:93-95); one shared ida per
            # sample, so constant across cams
            ida00 = float(p.ida_mat()[0, 0])
            ida_scales.append(
                np.full(
                    (intr.shape[0],),
                    np.sqrt(2.0) * abs(ida00),
                    np.float32,
                )
            )
    if extra_mults:
        images = [np.stack(images)] + [np.stack(e) for e in extra_images]
        images = np.stack(images)  # (A, B, N, H, W, 3)
        # matching (A, B, N, 4, 4) calibration stack, copy 0 = base ida
        l2is = [np.stack(l2is)] + [np.stack(e) for e in extra_l2is]
        l2is = np.stack(l2is)
    else:
        images = np.stack(images)
        l2is = np.stack(l2is)
    batch = {
        "images": images,
        "lidar2img": np.asarray(l2is, np.float32),
        "gt_bboxes": np.stack(gtb),
        "gt_labels": np.stack(gtl),
        "gt_valid": np.stack(gtv),
    }
    if maps:
        batch["maps"] = np.stack(maps)
    if intrs:
        batch["intrinsics"] = np.stack(intrs)
        batch["ida_scale"] = np.stack(ida_scales)
    if all("mean_time_stamp" in s for s in samples):
        batch["mean_time_stamp"] = np.asarray(
            [s["mean_time_stamp"] for s in samples], np.float32
        )
    return batch
