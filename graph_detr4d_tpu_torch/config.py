"""Dataclass configs mirroring the reference's semantic fields.

The reference drives everything through mmcv string-registry configs
(projects/configs/detr4d/detr4d_res50_deform_pe_testaug_2subset_12e.py);
here the same semantic knobs live in typed dataclasses consumed by plain
constructors. Field defaults reproduce that config's values.

This is the PyTorch port's own copy of `graph_detr4d_tpu/config.py`: the
same classes, fields and defaults (tests/test_torch_weights.py holds them
equal field for field), so a config built for one package describes the
same model in the other. The port accepts the TPU layout knobs
(`cam_chunk`, `batch_chunk`, `stem_s2d`, `msda_impl`, `msda_late_proj`,
`dcn_gather` other than 'int8') and does not act on them: on the GPU each
op has one kernel. `dcn_gather='int8'` selects the int8 DCN table (K3).
"""

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


NUSCENES_CLASSES = (
    "car",
    "truck",
    "construction_vehicle",
    "bus",
    "trailer",
    "barrier",
    "motorcycle",
    "bicycle",
    "pedestrian",
    "traffic_cone",
)

DEFAULT_PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
DEFAULT_POST_CENTER_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
DEFAULT_CODE_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)


@dataclass(frozen=True)
class BackboneConfig:
    depth: int = 50  # 18 | 34 | 50 | 101
    frozen_stages: int = 1
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    stage_with_dcn: Tuple[bool, ...] = (False, False, True, True)
    use_dcn: bool = True  # DCNv2 on stages 3-4 (configs/...12e.py:40-41)
    # jax.checkpoint per stage (VoVNetCP / torch.utils.checkpoint parity;
    # needed to fit 12-cam no-detach training in one chip's HBM)
    remat: bool = False
    # run the conv stack (backbone+neck) over the folded B*N camera axis
    # in chunks of this many images. XLA's fusion/layout choices for the
    # DCN gather-table pipeline degrade superlinearly past B*N=6 (round-3
    # op trace: feats 66.8 ms at 6 but 163.1 at 12, 2.44x); each 6-image
    # chunk already saturates the chip, so re-running the EXACT
    # 6-image program per chunk restores linear scaling. None = off.
    cam_chunk: Optional[int] = None
    # DCN large-grid tap-sampling kernel variant (ops/deform_conv.py):
    # 'shift4' (folded-corner fp gather, exact, default) | 'int8'
    # (per-(batch,channel) amax-quantized table: halves gather bandwidth,
    # ~0.4%-of-range worst-case value error, 5.7% box rank churn measured
    # — serving opt-in only, tools/int8_box_bound.py). Small grids always
    # use the exact one-hot MXU path regardless. CLI env override:
    # GRD4D_DCN_GATHER (configs.apply_env_kernel_overrides).
    dcn_gather: str = "shift4"
    # stem 7x7/2 conv computed via 2x2 space-to-depth + a 4x4 conv on 12
    # channels (exact kernel rearrangement, models/resnet.py
    # StemConvS2D). Same param tree as the plain conv, so checkpoints
    # and goldens are layout-identical. CLI env override: GRD4D_STEM_S2D.
    stem_s2d: bool = False


@dataclass(frozen=True)
class NeckConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    start_level: int = 1
    num_outs: int = 4
    relu_before_extra_convs: bool = True
    # CPFPN (cp_fpn.py:182-185): 3x3 fpn conv only on level 0, higher
    # levels pass the lateral through — the petr/petrv2 neck
    cp: bool = False


@dataclass(frozen=True)
class HeadConfig:
    num_query: int = 900
    num_classes: int = 10
    embed_dims: int = 256
    num_reg_fcs: int = 2
    num_decoder_layers: int = 6
    num_heads: int = 8
    num_levels: int = 4
    num_points: int = 4
    num_cams: int = 12
    ffn_dims: int = 512
    dropout: float = 0.1
    code_size: int = 10
    code_weights: Tuple[float, ...] = DEFAULT_CODE_WEIGHTS
    pc_range: Tuple[float, ...] = DEFAULT_PC_RANGE
    # PETR-style position embedding (detr3d_head_pe.py:427-491)
    depth_num: int = 64
    depth_start: float = 1.0
    pe_num_feats: int = 128  # SinePositionalEncoding3D num_feats
    with_box_refine: bool = True
    with_detach: bool = True  # stop-gradient past 6 cams (:512-516)
    scale_pred: bool = False  # depth_factors scaling (:592-595)
    num_frame_cams: int = 6  # cameras per temporal frame
    # H-DETR hybrid matching (h_detr3d_head_pe.py:40-693); 0 = disabled
    num_query_one2many: int = 0
    k_one2many: int = 6
    lambda_one2many: float = 2.0
    # cross-attention variant: 'deform3d' (Deform3DCrossAttn, flagship) |
    # 'deform3d_mp' (graph multi-point) | 'detr3d' (single-point DETR3D) |
    # 'detr3d_v2' (learned 2D image-plane offsets)
    attn_type: str = "deform3d"
    num_neighbors: int = 8  # graph neighbors for 'deform3d_mp'
    # per-camera query capacity fraction for the deform3d sampler; exact
    # whenever <= capacity queries project into a camera (overflow count
    # is sown as 'cam_overflow'); 1.0 = off
    cam_capacity: float = 1.0
    # lane query count for the seg head; must equal the BEV map's 16x16
    # patch count (petrv2_BEVseg.py:46 uses 256 for a 256x256 map)
    num_lane: int = 256
    with_fpe: bool = True  # SE gate on the 3D PE (detr3d_head_pe.py:546-553)
    # 'se' (SELayer) | 'camconv' (SELayerCAMConvV1: SE whose reduce conv
    # sees camera-intrinsic coordinate channels — the camconvfpe configs)
    fpe_type: str = "se"
    # False = plain Detr3DHead (no 3D position embedding at all,
    # models/dense_heads/detr3d_head.py:16-166 — the detr4d_res50.py
    # config family)
    with_pe: bool = True
    cam_aware: bool = False  # DepthNet feature modulation (PECAM head)
    # Deform3DCrossAttn option knobs (deform3d_cross_attn.py:64-65):
    # fix_offset freezes the sampling-offset linear (requires_grad=False
    # parity: zero param grads, input grads still flow); depth_encode
    # appends rho = sqrt(x^2+y^2) of the normalized reference point to
    # the positional-MLP input (:331-334, Linear(4) at :105)
    fix_offset: bool = False
    depth_encode: bool = False
    # run the (inference) head per batch slice of this size, unrolled —
    # the batch analog of BackboneConfig.cam_chunk. Exact: no head op
    # crosses the batch axis (float noise from per-shape scheduling
    # only). Round-3 on-chip ablation: the B=4
    # head costs 170.8 ms vs 4x the B=1 program's 35.7 (XLA scheduling
    # degrades at larger live sets; cost analysis is exactly linear), so
    # re-running the B=1 program per sample is faster. None = off.
    batch_chunk: Optional[int] = None
    # PETR/PETRv2/PETR-seg head options. Class defaults in the reference
    # are LID=False / (-65, -65, -8, 65, 65, 8) (petr_head.py:107, 177)
    # but EVERY shipped petr config overrides them to LID=True and
    # [-61.2, -61.2, -10, 61.2, 61.2, 10] (e.g.
    # configs/petr/petr_r50dcn_gridmask_p4.py:53-56), so those are the
    # defaults here. position_range scales only the 3D position
    # embedding; box denorm always uses pc_range.
    petr_lid: bool = True
    petr_position_range: Tuple[float, ...] = (
        -61.2, -61.2, -10.0, 61.2, 61.2, 10.0,
    )
    # MSDA large-level sampling layout (ops/msda.py): 'shift4h' (fastest
    # measured on chip, default) | 'pair' | 'shift4' | 'gather4' (pure
    # gather baseline, also disables the one-hot small-level branch —
    # required for honest A/B). CLI env override: GRD4D_MSDA_IMPL.
    msda_impl: str = "shift4h"
    # build MSDA gather tables from RAW features and fold value_proj in
    # afterwards (exact; lets XLA CSE the 6 decoder layers' table builds
    # into one). Measured slower at B=1 (9.62 vs 9.88 fps — the 4x-corner
    # projection matmul outweighs the saved churn), kept for larger-batch
    # experiments. CLI env override: GRD4D_MSDA_LATEPROJ=1.
    msda_late_proj: bool = False


@dataclass(frozen=True)
class CoderConfig:
    max_num: int = 300
    post_center_range: Tuple[float, ...] = DEFAULT_POST_CENTER_RANGE
    score_threshold: float | None = None
    num_classes: int = 10


@dataclass(frozen=True)
class LossConfig:
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    cls_weight: float = 2.0
    bbox_weight: float = 0.25
    bg_cls_weight: float = 0.0
    sync_cls_avg_factor: bool = True
    max_gt: int = 128  # static GT padding for jit
    # matching costs (configs/...12e.py:112-115)
    match_cls_weight: float = 2.0
    match_reg_weight: float = 0.25


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    backbone_lr_mult: float = 0.1
    weight_decay: float = 0.01
    grad_clip_norm: float = 35.0
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3
    min_lr_ratio: float = 1e-3
    total_steps: int = 84_408  # 12 epochs x nuScenes/2 @ 8x1
    grid_mask_prob: float = 0.7
    use_grid_mask: bool = True
    # train-pipeline aug switches (the reference's aug/rotaug/rotcropaug
    # config variants toggle exactly these, e.g.
    # detr4d_res50_deform_pe_rotaug_2subset_12e.py:142-148)
    photometric: bool = True
    ida_aug: bool = True  # ResizeCropFlipImage
    rot_aug: bool = True  # GlobalRotScaleTransImage
    # multi-scale training (RandomResizeImageMultiViewImage +
    # ScaleAnnotations3D, detr4d_res50_deform_ms.py:132-134): per sample,
    # a random (y, x) target from this list drives the depth-scaled
    # resize before ida brings the image to the static network size
    resize_scales: Optional[Tuple[Tuple[int, int], ...]] = None


@dataclass(frozen=True)
class ModelConfig:
    # 'detr4d_pe' (Detr3DHeadPE, flagship) | 'petr' | 'petrv2' | 'petr_seg'
    head_type: str = "detr4d_pe"
    backbone_type: str = "resnet"  # 'resnet' | 'vovnet'
    vovnet_spec: str = "V-99-eSE"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    neck: NeckConfig = field(default_factory=NeckConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    coder: CoderConfig = field(default_factory=CoderConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    img_size: Tuple[int, int] = (320, 800)  # (H, W), /32-divisible
    bf16: bool = True  # compute dtype for conv/matmul heavy paths
    # img_norm_cfg: the detr3d/detr4d families normalize RGB with
    # ImageNet stats (configs/...12e.py:13-14, to_rgb=True); the
    # petr/petrv2 families feed BGR (to_rgb=False) with caffe-style
    # means — petr_r50dcn uses std=1 (petr_r50dcn_gridmask_p4.py:13-14),
    # the vovnet/petrv2/BEVseg configs std=[57.375, 57.120, 58.395].
    # mean/std are in the CONSUMED channel order (BGR when img_bgr).
    img_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    img_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    img_bgr: bool = False  # model consumes BGR (reference to_rgb=False)
    # normalize (x - img_mean) / img_std ON DEVICE (detector.extract_feats,
    # fp32, before grid-mask — matching the reference's CPU-normalize ->
    # GridMask order) instead of in the host pipeline. The pipeline then
    # ships RAW uint8 pixels: 4x fewer host->device bytes than f32 (2x vs
    # bf16) on the transfer-bound remote-TPU train path, and the sub/div
    # moves onto the chip where it fuses into the first conv. Exact for
    # uint8-preserving pipelines (eval, train w/o photometric); the
    # photometric path ships float pixels (bf16 under cfg.bf16) and is
    # equal up to bf16 rounding of the raw values. Requires /32 img_size
    # (raw zero-padding is not normalized zero-padding; all shipped
    # configs are /32).
    device_normalize: bool = False


@dataclass(frozen=True)
class BEVConfig:
    """BEVFormer's BEV encoder (bevformer_base.py: bev_h_, bev_w_,
    BEVFormerEncoder, SpatialCrossAttention, TemporalSelfAttention)."""

    bev_h: int = 200
    bev_w: int = 200
    num_encoder_layers: int = 6
    num_points_in_pillar: int = 4  # heights a BEV cell's pillar projects
    sca_num_points: int = 8  # MSDeformableAttention3D points (2 a height)
    tsa_num_points: int = 4  # TemporalSelfAttention points, 1 level
    # SCA rows a camera keeps (its BEV queries with an in-view height,
    # lowest index first); exact while no camera sees more, the rest are
    # counted as bev_sca_overflow. The seeded 6-camera rig of the
    # benchmark (benchmark/harness/traffic.py::surround_rig) puts at most
    # 8,289 of the 40,000 queries in one camera over 4,000 seeded rigs.
    sca_capacity: int = 9216


@dataclass(frozen=True)
class BEVFormerConfig(ModelConfig):
    """A ModelConfig with BEVFormer's own fields: its BEV encoder and the
    ResNet style (mmcv 'caffe': the stride on the 1x1 conv1). A subclass,
    so that every other config keeps ModelConfig's fields."""

    bev: BEVConfig = field(default_factory=BEVConfig)
    resnet_style: str = "caffe"


def tiny_test_config() -> ModelConfig:
    """A small config for CPU tests: shrunk backbone/head, 6 cams."""
    return ModelConfig(
        backbone=BackboneConfig(depth=18, use_dcn=False),
        neck=NeckConfig(in_channels=(64, 128, 256, 512), out_channels=64),
        head=HeadConfig(
            num_query=24,
            embed_dims=64,
            num_decoder_layers=2,
            num_heads=4,
            num_points=2,
            num_cams=6,
            ffn_dims=128,
            depth_num=8,
            pe_num_feats=32,
            num_frame_cams=3,
            num_lane=16,
        ),
        coder=CoderConfig(max_num=12),
        loss=LossConfig(max_gt=8),
        img_size=(64, 128),
        bf16=False,
    )
