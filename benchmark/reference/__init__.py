"""Plain float32 references of the benchmark's configurations, one module
per configuration file's `reference`; they import nothing of the
measured package."""

import importlib


def load(name: str):
    """The reference module a configuration file names."""
    return importlib.import_module(f".{name}", __package__)
