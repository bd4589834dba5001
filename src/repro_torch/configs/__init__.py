"""Architecture registry of the port: only the architectures ported so far.

Each module exposes ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family configuration for CPU tests),
copied from ``repro.configs``. ``get_config(name)`` / ``get_smoke_config(name)``
dispatch by id.
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS: List[str] = [
    "gemma2-2b",
    "smollm-135m",
    "yi-34b",
    "stablelm-12b",
    "musicgen-medium",
    "arctic-480b",
    "deepseek-v2-236b",
]


def _module(name: str):
    if name not in ARCHS:
        raise ValueError(f"architecture {name!r} is not ported; ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()
