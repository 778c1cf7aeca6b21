"""YAML config loading: the same files as ``artiboost_tpu`` (plain
nested dicts with UPPERCASE keys)."""
from __future__ import annotations

from typing import Any, Dict

import yaml


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.safe_load(f)
