"""Named configs of the models the port runs, and `--cfg-options` overrides.

The port's copy of the entries of `graph_detr4d_tpu/configs/__init__.py`
whose every feature the port runs (`get_config`, `apply_overrides` and the
`_detr4d` helper): the detr4d `deform_pe` family, the plain head
(with_pe False), the MP, DETR3D and DETR3D-v2 cross-attentions and the
single-frame 6-camera models. Names and values are the JAX registry's
(tests/test_torch_weights.py holds them equal). Configs whose training
pipeline switches (`resize_scales`, `*_aug`) the port does not run yet are
left out.

    from graph_detr4d_tpu_torch.configs import get_config
    cfg = get_config("detr4d_res50_deform_pe_testaug_2subset_12e",
                     overrides=["head.num_query=600"])
"""

import ast
import dataclasses
import types
import typing
from typing import Callable, Dict, Optional, Sequence

from .config import HeadConfig, ModelConfig

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
