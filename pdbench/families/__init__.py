"""The model families the benchmark drives; a configuration file names its
family, and `families.load(name)` finds the module of that name."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"pdbench.families.{name}")
