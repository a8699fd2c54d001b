"""The port's kernels (CUDA sources under csrc/, built by build.py) and
their plain PyTorch versions."""

import sys

_PACKAGE = __name__.rpartition(".")[0]


def launch_counters() -> dict:
    """Every kernel launch counter of the port, {"<module>.<name>": count}:
    each module-level int whose name ends in `launches` (msda.launches,
    deform_conv.forward_launches, iou3d.launches, ...), in the port's
    imported modules; a module not imported has launched nothing."""
    out = {}
    for name, module in list(sys.modules.items()):
        if module is None or not name.startswith(_PACKAGE + "."):
            continue
        for attr, value in vars(module).items():
            if attr.endswith("launches") and type(value) is int:
                out[f"{name.rpartition('.')[2]}.{attr}"] = value
    return dict(sorted(out.items()))
