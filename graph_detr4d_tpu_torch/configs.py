"""Named configs of the models the port runs, and `--cfg-options` overrides.

The port's copy of the entries of `graph_detr4d_tpu/configs/__init__.py`
whose every feature the port runs (`get_config`, `apply_overrides` and the
`_detr4d` helper): the detr4d `deform_pe` family, the plain head
(with_pe False), the MP, DETR3D and DETR3D-v2 cross-attentions, the
single-frame 6-camera models, H-DETR's hybrid matching, the camera-aware
heads (DepthNet, the camconv gate, scale_pred), the VoVNet detectors and
the ResNet-18 and MobileNetV2 students, with the train-pipeline variants
(`*_aug`, `resize_scales`) that data/pipeline.py::build_batch runs, and the
PETR family (PETR, PETRv2, PETR-seg; CPFPN necks and the neck-less C5):
every entry of the JAX registry. Names and values are the JAX registry's
(tests/test_torch_weights.py and tests/test_torch_data.py hold them
equal).

Also the distillation bundles (`get_distill_config`, `DistillBundle`, the
18 `register_distill` entries of the JAX registry), held equal to JAX's
field for field by tests/test_torch_distill_cli.py.

    from graph_detr4d_tpu_torch.configs import get_config
    cfg = get_config("detr4d_res50_deform_pe_testaug_2subset_12e",
                     overrides=["head.num_query=600"])
    bundle = get_distill_config("mixdistill_r50_r18_cls_reg_img")
"""

import ast
import dataclasses
import types
import typing
from typing import Callable, Dict, Optional, Sequence

from .config import (BackboneConfig, BEVFormerConfig, CoderConfig,
                     HeadConfig, ModelConfig, NeckConfig, TrainConfig)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def list_configs():
    return sorted(_REGISTRY)


def get_config(
    name: str, overrides: Optional[Sequence[str]] = None
) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown config {name!r}; available: {', '.join(list_configs())}"
        )
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg, overrides: Sequence[str]):
    """Dot-path overrides on nested frozen dataclasses:
    'head.num_query=600' / 'bf16=False' / 'img_size=(320,800)'.

    Coercion follows the target field's declared type: bool and Optional
    fields take mmcv-style lowercase 'true'/'false'/'none', str fields keep
    the raw text."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        path, raw = ov.split("=", 1)
        keys = path.strip().split(".")
        value = _coerce(raw, _field_type(cfg, keys))
        cfg = _replace_path(cfg, keys, value)
    return cfg


def _field_type(obj, keys):
    """Declared type of the dataclass field at a dot path (None if the
    path doesn't resolve; _replace_path raises the real error)."""
    try:
        for k in keys[:-1]:
            obj = getattr(obj, k)
        for f in dataclasses.fields(obj):
            if f.name == keys[-1]:
                return f.type
    except (AttributeError, TypeError):
        pass
    return None


def _type_accepts(tp, target) -> bool:
    if tp is target:
        return True
    origin = typing.get_origin(tp)
    if origin is typing.Union or origin is types.UnionType:
        return any(_type_accepts(a, target) for a in typing.get_args(tp))
    return False


def _coerce(raw: str, tp):
    s = raw.strip()
    if tp is str:
        return s
    low = s.lower()
    if low in ("true", "false") and (tp is None or _type_accepts(tp, bool)):
        return low == "true"
    if low in ("none", "null") and (
        tp is None or _type_accepts(tp, type(None))
    ):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _replace_path(obj, keys, value):
    if len(keys) == 1:
        if not hasattr(obj, keys[0]):
            raise AttributeError(
                f"{type(obj).__name__} has no field {keys[0]!r}"
            )
        return dataclasses.replace(obj, **{keys[0]: value})
    child = getattr(obj, keys[0])
    return dataclasses.replace(
        obj, **{keys[0]: _replace_path(child, keys[1:], value)}
    )


def _detr4d(img_size=(640, 1600), **head_kw) -> ModelConfig:
    # cam_capacity=0.5: exact unless > Q/2 queries project into one camera
    # (the head reports the clipped count as 'cam_overflow')
    head = dict(num_cams=12, with_detach=False, cam_capacity=0.5)
    head.update(head_kw)
    return ModelConfig(head=HeadConfig(**head), img_size=img_size)


@register("detr4d_res50_deform_pe_testaug_2subset_12e")
def detr4d_flagship():
    """The flagship Graph-DETR4D (mAP 34.2 / NDS 44.5 recipe;
    configs/detr4d/detr4d_res50_deform_pe_testaug_2subset_12e.py)."""
    return _detr4d()


@register("detr4d_res50_deform_pe_2subset_12e")
def detr4d_no_testaug():
    # identical model; differs only in eval-time ida augmentation
    return _detr4d()


@register("detr4d_res50_deform_pe_testaug_detach_2subset_12e")
def detr4d_detach():
    return _detr4d(with_detach=True)


@register("detr4d_res50_deform_pe_450_2subset_12e")
def detr4d_450():
    return _detr4d(img_size=(448, 800))  # 450x800 padded /32


@register("detr4d_res50_deform_pe_testaug_320_800")
def detr4d_320():
    return _detr4d(img_size=(320, 800))


@register("detr4d_res50_deform_pe_mp_testaug_2subset_12e")
def detr4d_mp():
    """Graph multi-point neighbours (Deform3DCrossAttnMP)."""
    return _detr4d(attn_type="deform3d_mp")


@register("detr4d_res50")
def detr4d_res50_plain():
    """Plain Detr3DHead (no 3D PE) with single-point DETR3D attention
    (configs/detr4d/detr4d_res50.py:49,72)."""
    return _detr4d(with_pe=False, attn_type="detr3d")


@register("detr4d_res50_deform")
def detr4d_res50_deform():
    """Plain head + graph deformable sampling, no PE
    (configs/detr4d/detr4d_res50_deform.py:51,74)."""
    return _detr4d(with_pe=False)


@register("detr4d_res50_mp")
def detr4d_res50_mp():
    """Plain head + multi-point graph neighbours
    (configs/detr4d/detr4d_res50_mp.py:60,73)."""
    return _detr4d(with_pe=False, attn_type="deform3d_mp")


@register("detr3d_res50")
def detr3d_res50():
    """Single-frame DETR3D: 6 cams, single-point cross-attention
    (configs/detr3d/detr3d_res50.py)."""
    return ModelConfig(
        head=HeadConfig(num_cams=6, with_detach=False, attn_type="detr3d"),
        img_size=(640, 1600),
    )


@register("graph_detr3d_res50")
def graph_detr3d_res50():
    """Single-frame Graph-DETR3D: 6 cams with graph deformable sampling."""
    return ModelConfig(
        head=HeadConfig(num_cams=6, with_detach=False),
        img_size=(640, 1600),
    )


@register("graph_detr3d_res101")
def graph_detr3d_res101():
    """Graph-DETR3D with a ResNet-101 backbone."""
    cfg = graph_detr3d_res50()
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, depth=101)
    )


def _with_augs(cfg: ModelConfig, *, photo=True, ida=True, rot=True):
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train, photometric=photo, ida_aug=ida, rot_aug=rot
        ),
    )


@register("detr4d_res50_deform_ms")
def detr4d_res50_deform_ms():
    """Multi-scale training: random depth-scaled resizes
    (RandomResizeImageMultiViewImage + ScaleAnnotations3D,
    configs/detr4d/detr4d_res50_deform_ms.py:132-134)."""
    cfg = _detr4d(with_pe=False)
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train,
            resize_scales=(
                (400, 9999),
                (784, 9999),
                (848, 9999),
                (912, 9999),
                (976, 9999),
                (1040, 9999),
                (1104, 9999),
            ),
        ),
    )


@register("detr4d_res50_deform_aug_2subset_12e")
def detr4d_deform_aug():
    """photometric + ida crop/flip + BEV rot, the plain head
    (detr4d_res50_deform_aug_2subset_12e.py:142-153)."""
    return _with_augs(_detr4d(with_pe=False))


@register("detr4d_res50_deform_pe_aug_2subset_12e")
def detr4d_pe_aug():
    return _with_augs(_detr4d())


@register("detr4d_res50_deform_pe_rotaug_2subset_12e")
def detr4d_pe_rotaug():
    """photometric + BEV rot/scale, ida off
    (detr4d_res50_deform_pe_rotaug_2subset_12e.py:142-148)."""
    return _with_augs(_detr4d(), ida=False)


@register("detr4d_res50_deform_pe_rotcropaug_2subset_12e")
def detr4d_pe_rotcropaug():
    """photometric + ida + BEV rot, all on
    (detr4d_res50_deform_pe_rotcropaug_2subset_12e.py:143-148)."""
    return _with_augs(_detr4d())


@register("detr4d_res50_deform_camaware_pe_aug_2subset_12e")
def detr4d_camaware():
    """BEVDepth-style DepthNet modulation (Detr3DHeadPECAM). As in the JAX
    registry, the train augmentations keep their defaults."""
    return _detr4d(cam_aware=True)


@register("detr4d_res50_deform_camaware_fpe_2subset_12e")
def detr4d_camaware_fpe():
    return _detr4d(cam_aware=True, with_fpe=True)


@register("detr4d_res50_deform_simpleda_2subset_12e")
def detr4d_scale_aware():
    """Scale-aware depth-factor variant (scale_pred=True,
    RandomResizeMultiViewImage_SimpleDA pipeline)."""
    return _detr4d(scale_pred=True)


@register("detr4d_res50_deform_camconvfpe_2subset_12e")
def detr4d_camconvfpe():
    """SE gate with camera-intrinsic coordinate channels
    (SELayerCAMConvV1, detr3d_head_pe.py:277-295)."""
    return _detr4d(fpe_type="camconv")


@register("h_detr4d_res50_deform_pe_testaug_2subset_12e")
def h_detr4d():
    """H-DETR hybrid one2one + one2many matching
    (h_detr3d_head_pe.py:40-693)."""
    return _detr4d(
        num_query_one2many=1800, k_one2many=6, lambda_one2many=2.0
    )


@register("detr4d_res18_deform_pe_testaug_320_2subset")
def detr4d_r18():
    """The ResNet-18 distill student at 320x800, no DCN."""
    cfg = _detr4d(img_size=(320, 800))
    return dataclasses.replace(
        cfg,
        backbone=BackboneConfig(depth=18, use_dcn=False),
        neck=NeckConfig(in_channels=(64, 128, 256, 512)),
    )


@register("detr4d_vovnet")
def detr4d_vovnet_plain():
    """VoVNet backbone, plain head, single-point attention
    (configs/detr4d/detr4d_vovnet.py)."""
    cfg = _detr4d(with_pe=False, attn_type="detr3d")
    return dataclasses.replace(
        cfg,
        backbone_type="vovnet",
        neck=NeckConfig(in_channels=(256, 512, 768, 1024)),
    )


@register("detr4d_vovnet_deform")
def detr4d_vovnet():
    """The flagship's head on VoVNet V-99-eSE."""
    cfg = _detr4d()
    return dataclasses.replace(
        cfg,
        backbone_type="vovnet",
        neck=NeckConfig(in_channels=(256, 512, 768, 1024)),
    )


@register("detr4d_m2_deform_pe_testaug_320_fullset")
def detr4d_m2():
    """MobileNetV2 student (configs/detr4d/detr4d_m2_..._fullset.py:51)."""
    cfg = _detr4d(img_size=(320, 800))
    return dataclasses.replace(
        cfg,
        backbone_type="mobilenetv2",
        backbone=BackboneConfig(out_indices=(2, 4, 7)),
        neck=NeckConfig(in_channels=(32, 96, 1280), start_level=0),
    )


# --------------------------------------------------------- petr family
def _petr(backbone="resnet", img_size=(320, 800), **kw) -> ModelConfig:
    """PETR-family base: 2-level CPFPNs over the backbone's last two maps
    (petr_r50dcn_gridmask_p4.py:33, 43-47; petrv2_vovnet...py:35-40); the
    head reads level 0, the stride-16 map. BGR input with caffe means and
    std [57.375, 57.120, 58.395] (petrv2_*.py:13-16), no photometric
    distortion in any PETR-family train pipeline."""
    head = dict(num_cams=6, with_detach=False)
    head.update(kw)
    cfg = ModelConfig(
        head_type="petr",
        head=HeadConfig(**head),
        img_size=img_size,
        neck=NeckConfig(
            in_channels=(1024, 2048), start_level=0, num_outs=2, cp=True
        ),
        img_mean=(103.530, 116.280, 123.675),
        img_std=(57.375, 57.120, 58.395),
        img_bgr=True,
        train=TrainConfig(photometric=False),
    )
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, out_indices=(2, 3))
    )
    if backbone == "vovnet":
        cfg = dataclasses.replace(
            cfg,
            backbone_type="vovnet",
            neck=dataclasses.replace(cfg.neck, in_channels=(768, 1024)),
        )
    return cfg


@register("petr_r50dcn_gridmask_p4")
def petr_r50():
    """PETRv1 R50-DCN: std 1.0 (petr_r50dcn_gridmask_p4.py:13-14)."""
    return dataclasses.replace(_petr(), img_std=(1.0, 1.0, 1.0))


@register("petr_vovnet_gridmask_p4_800x320")
def petr_vovnet_800():
    return _petr(backbone="vovnet")


@register("petr_vovnet_gridmask_p4_1600x640")
def petr_vovnet_1600():
    return _petr(backbone="vovnet", img_size=(640, 1600))


@register("petrv2_res50_gridmask_p4_800x320")
def petrv2_r50():
    """R50 + DCN on stages 3-4 under the flagship's standard 4-level FPN
    (start_level 1, 'on_output' extra convs): level 0 is the stride-8
    map (petrv2_res50_gridmask_p4_800x320.py:31-49)."""
    cfg = _petr(num_cams=12)
    return dataclasses.replace(
        cfg,
        head_type="petrv2",
        backbone=dataclasses.replace(cfg.backbone, out_indices=(0, 1, 2, 3)),
        neck=NeckConfig(),
    )


@register("petrv2_vovnet_gridmask_p4_800x320")
def petrv2_vovnet():
    cfg = _petr(backbone="vovnet", num_cams=12)
    return dataclasses.replace(cfg, head_type="petrv2")


@register("petr_r50dcn_gridmask_c5")
def petr_c5():
    """PETR over the raw C5 map: no img_neck, the head's input_proj reads
    the 2048-channel C5 (petr_r50dcn_gridmask_c5.py:46)."""
    cfg = _petr()
    return dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(cfg.backbone, out_indices=(3,)),
        neck=dataclasses.replace(cfg.neck, num_outs=0),
        head=dataclasses.replace(cfg.head, num_levels=1),
        img_std=(1.0, 1.0, 1.0),
    )


@register("petrv2_vovnet_gridmask_p4_1600x640")
def petrv2_vovnet_1600():
    cfg = _petr(backbone="vovnet", img_size=(640, 1600), num_cams=12)
    return dataclasses.replace(cfg, head_type="petrv2")


@register("petrv2_vovnet_gridmask_p4_1600x640_trainval")
def petrv2_vovnet_1600_trainval():
    return petrv2_vovnet_1600()


@register("petrv2_BEVseg")
def petrv2_bevseg():
    """PETR + BEV map segmentation (Petr3D_seg + PETRHeadseg): VoVNet
    V-99-eSE with remat over stages 4-5, CPFPN [768, 1024], 12 temporal
    cameras, with_time and with_se (petrv2_BEVseg.py:27-56)."""
    cfg = _petr(backbone="vovnet", num_cams=12)
    return dataclasses.replace(
        cfg,
        head_type="petr_seg",
        backbone=dataclasses.replace(cfg.backbone, remat=True),
    )


@register("bevformer_base")
def bevformer_base():
    """BEVFormer-base (Li et al., ECCV 2022; fundamentalvision/BEVFormer
    projects/configs/bevformer/bevformer_base.py): ResNet-101 in the caffe
    style with DCNv2 on stages 3-4, an FPN from C3 with one extra output,
    a 200 x 200 BEV encoder of 6 layers (temporal self-attention over the
    previous BEV, spatial cross-attention into the 6 cameras) and a
    900-query deformable decoder over the BEV. The port's own entry: the
    JAX package has no BEVFormer."""
    return BEVFormerConfig(
        head_type="bevformer",
        backbone=BackboneConfig(depth=101, out_indices=(1, 2, 3)),
        neck=NeckConfig(in_channels=(512, 1024, 2048), start_level=0),
        head=HeadConfig(num_cams=6, num_frame_cams=6, with_detach=False),
        coder=CoderConfig(max_num=300),
        img_size=(928, 1600),  # 900 x 1600 padded /32
        img_mean=(103.530, 116.280, 123.675),
        img_std=(1.0, 1.0, 1.0),
        img_bgr=True,
    )


# the entries of the port that the JAX registry does not have
PORT_ONLY = ("bevformer_base",)


# ------------------------------------------------------------- distill
@dataclasses.dataclass(frozen=True)
class DistillBundle:
    """Teacher and student configs and the distill loss switches, the
    semantic content of the reference's projects/distill_cfg/*: the
    cls / reg / img / reweight / mix switch matrix."""

    teacher: ModelConfig
    student: ModelConfig
    distill_cls: bool = True
    distill_reg: bool = True
    distill_feat: bool = False
    feat_mode: str = "vanilla"  # 'vanilla' | 'attention'
    reweight_score: bool = False
    mix: bool = False  # MixDistill teacher-query guided decode
    # loss weights; None derives them from the booleans (cls 1.0, reg
    # 0.25, feat 1.0); the named ablations set the reference's literals
    cls_weight: Optional[float] = None
    reg_weight: Optional[float] = None
    feat_weight: Optional[float] = None

    @property
    def effective_cls_weight(self) -> float:
        if self.cls_weight is not None:
            return self.cls_weight
        return 1.0 if self.distill_cls else 0.0

    @property
    def effective_reg_weight(self) -> float:
        if self.reg_weight is not None:
            return self.reg_weight
        return 0.25 if self.distill_reg else 0.0

    @property
    def effective_feat_weight(self) -> float:
        return 1.0 if self.feat_weight is None else self.feat_weight

    # the soft-GT rows: the top-K teacher queries by max sigmoid score;
    # None takes all of them (distill_train's --teacher-top-k overrides)
    teacher_top_k: Optional[int] = 64


_DISTILL: Dict[str, Callable[[], DistillBundle]] = {}


def register_distill(name: str):
    def deco(fn):
        _DISTILL[name] = fn
        return fn

    return deco


def list_distill_configs():
    return sorted(_DISTILL)


def _pin_distill_safe_msda(cfg: ModelConfig) -> ModelConfig:
    """The JAX registry pins both models of a bundle to msda_impl
    'gather4', a TPU sampling layout; the port ignores the field and keeps
    the pin so that its bundles equal JAX's field for field."""
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, msda_impl="gather4")
    )


def get_distill_config(name: str) -> DistillBundle:
    if name not in _DISTILL:
        raise KeyError(
            f"unknown distill config {name!r}; available: "
            f"{', '.join(list_distill_configs())}"
        )
    b = _DISTILL[name]()
    return dataclasses.replace(
        b,
        teacher=_pin_distill_safe_msda(b.teacher),
        student=_pin_distill_safe_msda(b.student),
    )


def _r50_r18(**kw):
    return DistillBundle(
        teacher=get_config("detr4d_res50_deform_pe_testaug_320_800"),
        student=get_config("detr4d_res18_deform_pe_testaug_320_2subset"),
        **kw,
    )


@register_distill("distill_r50_r18_cls_2subset")
def d_cls():
    return _r50_r18(distill_cls=True, distill_reg=False)


@register_distill("distill_r50_r18_cls_reg_2subset")
def d_cls_reg():
    # the reference's literal weights: cls 1.0, reg 1.0
    # (distill_r50_r18_cls_reg_2subset.py:12)
    return _r50_r18(reg_weight=1.0)


@register_distill("distill_r50_r18_reg_2subset")
def d_reg():
    """reg-only instance distill (distill_r50_r18_reg_2subset.py:12)."""
    return _r50_r18(distill_cls=False, reg_weight=1.0)


@register_distill("distill_r50_r18_cls_reweight_2subset")
def d_cls_rw():
    """cls-only with reweight_score, which touches only the reg term
    (detr3d_head_pe.py:907-911): inert here, kept for the name."""
    return _r50_r18(distill_reg=False, reweight_score=True)


@register_distill("distill_r50_r18_reg_reweight_2subset")
def d_reg_rw():
    # reg L1 0.25 with reweight_score (distill_r50_r18_reg_reweight_2subset.py:17-19)
    return _r50_r18(distill_cls=False, reweight_score=True)


@register_distill("distill_r50_r18_img_2subset")
def d_img():
    # feature distill, weight 1.0 (distill_r50_r18_img_2subset.py:18)
    return _r50_r18(distill_cls=False, distill_reg=False, distill_feat=True)


@register_distill("distill_r50_r18_img001_2subset")
def d_img001():
    """vanilla feature distill at weight 0.01
    (distill_r50_r18_img001_2subset_ceph.py:17-18)."""
    return _r50_r18(
        distill_cls=False,
        distill_reg=False,
        distill_feat=True,
        feat_weight=0.01,
    )


@register_distill("distill_r50_r18_img_att_2subset")
def d_img_att():
    # attention feature distill, weight 1e-3 (distill_r50_r18_img_att_2subset.py:19)
    return _r50_r18(
        distill_cls=False,
        distill_reg=False,
        distill_feat=True,
        feat_mode="attention",
        feat_weight=1e-3,
    )


@register_distill("distill_r50_r18_img_att_5e3_2subset")
def d_img_att_5e3():
    """attention feature distill at weight 5e-3
    (distill_r50_r18_img_att_5e3_2subset.py:16)."""
    return _r50_r18(
        distill_cls=False,
        distill_reg=False,
        distill_feat=True,
        feat_mode="attention",
        feat_weight=5e-3,
    )


@register_distill("distill_r50_r18_none_2subset")
def d_none():
    """No distill loss: the student baseline under the distill runner
    (distill_r50_r18_none_2subset_ceph.py)."""
    return _r50_r18(distill_cls=False, distill_reg=False, distill_feat=False)


# MixDistill defaults reweight_score=True (mix_distill.py:23); the *_wore
# ablations (without reweight) set it False
@register_distill("mixdistill_r50_r18_cls_2subset")
def md_cls():
    return _r50_r18(mix=True, distill_reg=False, reweight_score=True)


@register_distill("mixdistill_r50_r18_cls_wore_2subset")
def md_cls_wore():
    return _r50_r18(mix=True, distill_reg=False, reweight_score=False)


@register_distill("mixdistill_r50_r18_reg_2subset")
def md_reg():
    return _r50_r18(mix=True, distill_cls=False, reweight_score=True)


@register_distill("mixdistill_r50_r18_reg_wore_2subset")
def md_reg_wore():
    return _r50_r18(mix=True, distill_cls=False, reweight_score=False)


@register_distill("mixdistill_r50_r18_cls_reg_2subset")
def md_cls_reg():
    return _r50_r18(mix=True, reweight_score=True)


@register_distill("mixdistill_r50_r18_cls_reg_img")
def md_cls_reg_img():
    # vanilla feature distill, weight 0.1 (mixdistill_r50_r18_cls_reg_img_ceph.py:17)
    return _r50_r18(
        mix=True, distill_feat=True, feat_weight=0.1, reweight_score=True
    )


@register_distill("detr4d_r50_distill_r50_1x")
def d_r50_r50():
    """A trained R50 teacher and a fresh R50 student, both the flagship
    (configs/distillers/objdgcnn_Gdetr4d_r50_distill_Gdetr4d_r50_1x_*: the
    'objdgcnn' of the name is vestigial)."""
    flagship = get_config("detr4d_res50_deform_pe_testaug_2subset_12e")
    return DistillBundle(teacher=flagship, student=flagship)


@register_distill("mixdistill_r50_m2_cls_reg_img")
def md_m2():
    # vanilla feature distill 0.1 with MixDistill's reweight_score
    # (mixdistill_r50_m2_cls_reg_img_ceph.py:17)
    return DistillBundle(
        teacher=get_config("detr4d_res50_deform_pe_testaug_320_800"),
        student=get_config("detr4d_m2_deform_pe_testaug_320_fullset"),
        mix=True,
        distill_feat=True,
        feat_weight=0.1,
        reweight_score=True,
    )
