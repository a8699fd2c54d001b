"""Print a fully resolved named config (counterpart of
tools/misc/print_config.py; reference tools/misc/print_config.py).

    python -m graph_detr4d_tpu_torch.tools.print_config --list
    python -m graph_detr4d_tpu_torch.tools.print_config \\
        --config detr4d_res50_deform_pe_testaug_2subset_12e \\
        [--cfg-options head.num_query=600]

Prints what the JAX tool prints, byte for byte: the registry's model and
distill config names, or the config as indented JSON of its fields. The
port's own entries (configs.PORT_ONLY: BEVFormer), which the JAX package
does not have, are listed among the model configs too.
Host-only: it reads the registry and needs no device.
"""

import argparse
import dataclasses
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.print_config")
    p.add_argument("--config", default=None)
    p.add_argument("--cfg-options", nargs="*", default=None)
    p.add_argument("--list", action="store_true", help="list config names")
    return p.parse_args(argv)


def main(argv=None):
    from ..configs import get_config, list_configs, list_distill_configs

    args = parse_args(argv)
    if args.list or not args.config:
        print("model configs:")
        for n in list_configs():
            print(f"  {n}")
        print("distill configs:")
        for n in list_distill_configs():
            print(f"  {n}")
        return
    cfg = get_config(args.config, overrides=args.cfg_options)
    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))


if __name__ == "__main__":
    main()
