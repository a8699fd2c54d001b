"""GraphDETR4D detector: grid mask -> backbone -> FPN -> head
(counterpart of graph_detr4d_tpu/models/detector.py with a ResNet, VoVNet
or MobileNetV2 backbone; an FPN, a CPFPN or no neck; and the `detr4d_pe`
head, with or without its 3D position embedding, with any of the
cross-attentions of models/transformer.py, H-DETR's one2many query group
and the camera-aware options of models/head.py, or a head of the PETR
family: `petr`, `petrv2` (models/petr_head.py) and `petr_seg`
(models/petr_seg.py)). The grid mask and dropout apply only in training
(detr3d.py:53-54), drawn from the generator the forward is given.

All cameras fold into the batch axis for the conv stack (detr3d.py:62-66),
then unfold to (B, N, ...) for the head. On a camera shard
(`shard_cameras`) the images are the rank's cameras only, so the conv
stack runs on those (the JAX package's constrain points). The convs run NCHW tensors whose
memory is channels-last: the (B*N, H, W, 3) images viewed as NCHW already
are.
"""

import torch
import torch.nn as nn

from .. import tracing
from ..config import ModelConfig
from ..utils.device import resolve_device
from .attention import Deform3DCrossAttn
from .attention_variants import (Deform3DCrossAttnMP, Detr3DCrossAtten,
                                 Detr3DCrossAttenV2)
from .fpn import FPN
from .grid_mask import apply_grid_mask, grid_mask_params
from .head import Detr3DHeadPE
from .mobilenet import MobileNetV2
from .petr_head import CrossAttention, PETRHead
from .petr_seg import PETRHeadSeg
from .resnet import ResNet
from .transformer import ATTN_TYPES
from .vovnet import VoVNet


# the batch entries a model takes besides images and lidar2img: scale_pred's
# depth_factors, PETRv2's mean_time_stamp and the camera-aware head's
# intrinsics and ida_scale
MODEL_EXTRAS = ("depth_factors", "mean_time_stamp", "intrinsics", "ida_scale")


def model_extras(batch: dict) -> dict:
    """The MODEL_EXTRAS a batch carries, as keyword arguments of
    GraphDETR4D.forward (the JAX steps' batch.get)."""
    return {k: batch[k] for k in MODEL_EXTRAS if batch.get(k) is not None}


# the modules that mix cameras, each reading its slice from `cam_shard`
CAM_MIXING = (Deform3DCrossAttn, Deform3DCrossAttnMP, Detr3DCrossAtten,
              Detr3DCrossAttenV2, CrossAttention)

BACKBONE_TYPES = ("resnet", "vovnet", "mobilenetv2")
HEAD_TYPES = ("detr4d_pe", "petr", "petrv2", "petr_seg")


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


PETR_HEADS = ("petr", "petrv2", "petr_seg")


def build_head(cfg: ModelConfig, in_channels: int) -> nn.Module:
    """The head of cfg.head_type (the JAX detector's setup, detector.py:
    71-116) over level-0 features of `in_channels` channels: PETRv2 turns
    on with_time, the fpe gate (as head.with_fpe says), the grouped reg
    branch and per-layer branches; PETR-seg is temporal iff the rig
    carries past-frame cameras, and head.with_fpe is its `se` gate."""
    h = cfg.head
    if cfg.head_type in ("petr", "petrv2"):
        v2 = cfg.head_type == "petrv2"
        return PETRHead(h, cfg.img_size, in_channels, with_time=v2,
                        with_fpe=v2 and h.with_fpe, with_multi=v2,
                        per_layer_branches=v2)
    if cfg.head_type == "petr_seg":
        return PETRHeadSeg(h, cfg.img_size, in_channels,
                           with_time=h.num_cams > h.num_frame_cams,
                           with_se=h.with_fpe)
    return Detr3DHeadPE(h, cfg.img_size)


def check_supported(cfg: ModelConfig):
    """Raise for a config value the port does not know."""
    h = cfg.head
    unsupported = {
        "head_type": cfg.head_type not in HEAD_TYPES,
        "backbone_type": cfg.backbone_type not in BACKBONE_TYPES,
        "head.attn_type": h.attn_type not in ATTN_TYPES,
        "head.fpe_type": h.fpe_type not in ("se", "camconv"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"graph_detr4d_tpu_torch does not implement {bad} yet"
        )


def shard_cameras(model: nn.Module, mesh) -> nn.Module:
    """Put `model` on the cam group of a parallel/mesh.py Mesh (the
    identity for mesh.cam 1): its head and every module of it that mixes
    cameras read their camera slice from the mesh. Those are the
    cross-attentions of models/attention.py and attention_variants.py
    (the Detr3DHeadPE family: the flagship, H-DETR, the camera-aware
    heads, MP, DETR3D, DETR3D-v2, MixDistill's student) and the PETR
    heads' dense cross-attentions (PETR, PETRv2, PETR-seg). Any other
    model, ObjDGCNN among them, raises: it has no camera axis to shard."""
    if mesh is None or mesh.cam == 1:
        return model
    if not isinstance(model, GraphDETR4D):
        raise NotImplementedError(
            f"camera parallelism (cam={mesh.cam}) shards the camera axis of "
            f"a GraphDETR4D; {type(model).__name__} has none")
    cfg = model.cfg
    if cfg.head.num_cams % mesh.cam:
        raise ValueError(f"{cfg.head.num_cams} cameras not divisible by "
                         f"cam={mesh.cam}")
    model.pts_bbox_head.cam_shard = mesh
    for m in model.modules():
        if isinstance(m, CAM_MIXING):
            m.cam_shard = mesh
    return model


class GraphDETR4D(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        dev = resolve_device(device)
        check_supported(cfg)
        super().__init__()
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        self.img_backbone = build_backbone(cfg)
        n = cfg.neck
        # neck-less (petr_r50dcn_gridmask_c5): the head reads the raw C5,
        # whose channels the neck config's in_channels name
        self.img_neck = None if n.num_outs == 0 else FPN(
            in_channels=n.in_channels,
            out_channels=n.out_channels,
            start_level=n.start_level,
            num_outs=n.num_outs,
            relu_before_extra_convs=n.relu_before_extra_convs,
            cp=n.cp,
        )
        self.pts_bbox_head = build_head(
            cfg, n.in_channels[-1] if self.img_neck is None else n.out_channels)
        self.to(dev)

    def extract_feats(self, images: torch.Tensor, generator=None):
        """images (B, N, H, W, 3) -> L x (B, N, h, w, C) in the compute
        dtype. generator: training's random source for the grid mask;
        None in eval."""
        with tracing.span("model.backbone", device=True):
            B, N, H, W, _ = images.shape
            if self.cfg.device_normalize:
                mean = torch.tensor(self.cfg.img_mean, device=images.device)
                std = torch.tensor(self.cfg.img_std, device=images.device)
                images = (images.float() - mean) / std
            tc = self.cfg.train
            if generator is not None and tc.use_grid_mask:
                # after normalisation, so a masked pixel is 0 in normalized
                # space
                apply, d, l, st_h, st_w = grid_mask_params(
                    generator, H, tc.grid_mask_prob)
                images = apply_grid_mask(images, d, l, st_h, st_w, apply)
            x = images.reshape(B * N, H, W, 3).to(self.dtype).permute(
                0, 3, 1, 2)
            feats = self.img_backbone(x)
            if self.img_neck is not None:
                feats = self.img_neck(feats)
            return [
                f.permute(0, 2, 3, 1).reshape(B, N, f.shape[2], f.shape[3], -1)
                for f in feats
            ]

    def forward_feats(self, feats, lidar2img: torch.Tensor, generator=None,
                      depth_factors=None, mean_time_stamp=None,
                      intrinsics=None, ida_scale=None,
                      teacher_query_embed=None):
        """Head-only forward over precomputed camera features. The extras
        (depth_factors (B,), mean_time_stamp (B,), intrinsics (B, N, 4, 4),
        ida_scale (B, N)) reach the heads that read them: scale_pred, the
        PETR family and the camera-aware head. teacher_query_embed:
        MixDistill's (Qt, 2C) teacher query table, decoded a second time
        (models/head.py)."""
        with tracing.span("model.head", device=True):
            if self.cfg.head_type in PETR_HEADS:
                return self.pts_bbox_head(feats, lidar2img, generator,
                                          mean_time_stamp=mean_time_stamp)
            return self.pts_bbox_head(
                feats, lidar2img, generator, depth_factors=depth_factors,
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
        `extras` (MODEL_EXTRAS) go to every copy."""
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
                mean_time_stamp=None, intrinsics=None, ida_scale=None,
                teacher_query_embed=None):
        """images (B, N, H, W, 3) normalized (raw pixels with
        cfg.device_normalize); lidar2img (B, N, 4, 4). train=True draws the
        grid mask and dropout from `generator`, a torch.Generator on the
        model's device; eval ignores it. depth_factors, mean_time_stamp,
        intrinsics, ida_scale and teacher_query_embed: see
        forward_feats."""
        if not train:
            generator = None
        elif generator is None:
            raise ValueError("train=True needs a generator for the grid "
                             "mask and dropout")
        return self.forward_feats(self.extract_feats(images, generator),
                                  lidar2img, generator,
                                  depth_factors=depth_factors,
                                  mean_time_stamp=mean_time_stamp,
                                  intrinsics=intrinsics, ida_scale=ida_scale,
                                  teacher_query_embed=teacher_query_embed)
