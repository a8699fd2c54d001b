"""Tiny widths of the benchmark's configurations for CPU tests: every
kind of layer kept, 64x160 images, 24 queries, 2 decoder layers."""

import dataclasses
import json
import os

from graph_detr4d_tpu_torch.configs import get_config

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

TINY = ["img_size=(64,160)", "head.num_query=24", "head.embed_dims=64",
        "head.num_heads=4", "head.num_points=2", "head.num_decoder_layers=2",
        "head.ffn_dims=128", "head.depth_num=8", "head.pe_num_feats=32",
        "neck.out_channels=64", "coder.max_num=12"]


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def tiny_model(name, extra=()):
    """(the program's ModelConfig, its dict as a configuration file holds
    it) of configuration `name` at tiny widths."""
    from harness.cell import plain

    c = config(name)
    cfg = get_config(c["port_config"], c.get("overrides", []) + TINY + list(extra))
    return cfg, plain(dataclasses.asdict(cfg))
