"""GraphDETR4D detector: grid mask -> backbone -> FPN -> head
(counterpart of graph_detr4d_tpu/models/detector.py with a ResNet, VoVNet
or MobileNetV2 backbone and the `detr4d_pe` head, with or without its 3D position embedding, with
any of the cross-attentions of models/transformer.py, H-DETR's one2many
query group and the camera-aware options of models/head.py). The grid mask
and dropout apply only in training (detr3d.py:53-54), drawn from the
generator the forward is given.

All cameras fold into the batch axis for the conv stack (detr3d.py:62-66),
then unfold to (B, N, ...) for the head. The convs run NCHW tensors whose
memory is channels-last: the (B*N, H, W, 3) images viewed as NCHW already
are.
"""

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..utils.device import resolve_device
from .fpn import FPN
from .grid_mask import apply_grid_mask, grid_mask_params
from .head import Detr3DHeadPE
from .mobilenet import MobileNetV2
from .resnet import ResNet
from .transformer import ATTN_TYPES
from .vovnet import VoVNet


# the batch entries a model takes besides images and lidar2img: scale_pred's
# depth_factors and the camera-aware head's intrinsics and ida_scale
MODEL_EXTRAS = ("depth_factors", "intrinsics", "ida_scale")


def model_extras(batch: dict) -> dict:
    """The MODEL_EXTRAS a batch carries, as keyword arguments of
    GraphDETR4D.forward (the JAX steps' batch.get)."""
    return {k: batch[k] for k in MODEL_EXTRAS if batch.get(k) is not None}


BACKBONE_TYPES = ("resnet", "vovnet", "mobilenetv2")


def build_backbone(cfg: ModelConfig) -> nn.Module:
    """The backbone of cfg.backbone_type (the JAX detector's setup,
    detector.py:31-56): VoVNet (cfg.vovnet_spec, remat), MobileNetV2, or
    ResNet for any other type."""
    b = cfg.backbone
    if cfg.backbone_type == "vovnet":
        return VoVNet(cfg.vovnet_spec, b.out_indices, remat=b.remat)
    if cfg.backbone_type == "mobilenetv2":
        return MobileNetV2(b.out_indices)
    return ResNet(depth=b.depth, out_indices=b.out_indices,
                  stage_with_dcn=b.stage_with_dcn, use_dcn=b.use_dcn,
                  dcn_gather=b.dcn_gather)


def check_supported(cfg: ModelConfig):
    """Raise for the config features this slice of the port does not run."""
    h = cfg.head
    unsupported = {
        "head_type": cfg.head_type != "detr4d_pe",
        "backbone_type": cfg.backbone_type not in BACKBONE_TYPES,
        "head.attn_type": h.attn_type not in ATTN_TYPES,
        "head.fpe_type": h.fpe_type not in ("se", "camconv"),
        "neck.cp": cfg.neck.cp,
        "neck.num_outs": cfg.neck.num_outs == 0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"graph_detr4d_tpu_torch does not implement {bad} yet"
        )


class GraphDETR4D(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        dev = resolve_device(device)
        check_supported(cfg)
        super().__init__()
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        self.img_backbone = build_backbone(cfg)
        self.img_neck = FPN(
            in_channels=cfg.neck.in_channels,
            out_channels=cfg.neck.out_channels,
            start_level=cfg.neck.start_level,
            num_outs=cfg.neck.num_outs,
            relu_before_extra_convs=cfg.neck.relu_before_extra_convs,
        )
        self.pts_bbox_head = Detr3DHeadPE(cfg.head, cfg.img_size)
        self.to(dev)

    def extract_feats(self, images: torch.Tensor, generator=None):
        """images (B, N, H, W, 3) -> L x (B, N, h, w, C) in the compute
        dtype. generator: training's random source for the grid mask;
        None in eval."""
        B, N, H, W, _ = images.shape
        if self.cfg.device_normalize:
            mean = torch.tensor(self.cfg.img_mean, device=images.device)
            std = torch.tensor(self.cfg.img_std, device=images.device)
            images = (images.float() - mean) / std
        tc = self.cfg.train
        if generator is not None and tc.use_grid_mask:
            # after normalisation, so a masked pixel is 0 in normalized space
            apply, d, l, st_h, st_w = grid_mask_params(
                generator, H, tc.grid_mask_prob)
            images = apply_grid_mask(images, d, l, st_h, st_w, apply)
        x = images.reshape(B * N, H, W, 3).to(self.dtype).permute(0, 3, 1, 2)
        feats = self.img_neck(self.img_backbone(x))
        return [
            f.permute(0, 2, 3, 1).reshape(B, N, f.shape[2], f.shape[3], -1)
            for f in feats
        ]

    def forward_feats(self, feats, lidar2img: torch.Tensor, generator=None,
                      depth_factors=None, intrinsics=None, ida_scale=None,
                      teacher_query_embed=None):
        """Head-only forward over precomputed camera features. The extras
        (depth_factors (B,), intrinsics (B, N, 4, 4), ida_scale (B, N))
        reach the heads that read them: scale_pred and the camera-aware
        head. teacher_query_embed: MixDistill's (Qt, 2C) teacher query
        table, decoded a second time (models/head.py)."""
        return self.pts_bbox_head(feats, lidar2img, generator,
                                  depth_factors=depth_factors,
                                  intrinsics=intrinsics, ida_scale=ida_scale,
                                  teacher_query_embed=teacher_query_embed)

    def aug_forward(self, images_list, lidar2img, **extras):
        """Test-time augmentation (graph_detr4d_tpu/models/detector.py:
        170-204): one eval forward per copy in images_list, each with its
        own calibration (lidar2img (B, N, 4, 4) shared by every copy, or a
        list or (A, B, N, 4, 4) tensor of one per copy), then the mean of
        the head outputs, which are query-aligned across copies. The
        reference's aug_test averages features under copy 0's
        calibration; the JAX method averages outputs, and so does this.
        `extras` (depth_factors, intrinsics, ida_scale) go to every copy."""
        if isinstance(lidar2img, (list, tuple)) or lidar2img.dim() == 5:
            l2is = list(lidar2img)
        else:
            l2is = [lidar2img] * len(images_list)
        outs = [self.forward(im, l2i, **extras)
                for im, l2i in zip(images_list, l2is)]
        n = float(len(outs))
        return {k: sum(o[k] for o in outs) / n for k in outs[0]}

    def forward(self, images: torch.Tensor, lidar2img: torch.Tensor,
                train: bool = False, generator=None, depth_factors=None,
                intrinsics=None, ida_scale=None, teacher_query_embed=None):
        """images (B, N, H, W, 3) normalized (raw pixels with
        cfg.device_normalize); lidar2img (B, N, 4, 4). train=True draws the
        grid mask and dropout from `generator`, a torch.Generator on the
        model's device; eval ignores it. depth_factors, intrinsics,
        ida_scale and teacher_query_embed: see forward_feats."""
        if not train:
            generator = None
        elif generator is None:
            raise ValueError("train=True needs a generator for the grid "
                             "mask and dropout")
        return self.forward_feats(self.extract_feats(images, generator),
                                  lidar2img, generator,
                                  depth_factors=depth_factors,
                                  intrinsics=intrinsics, ida_scale=ida_scale,
                                  teacher_query_embed=teacher_query_embed)
