"""A configuration file (`configs/<name>.json`) as the dataclasses of a
config module: the port's `config.py` for the program, the reference's
copy of it for the reference. Each section of the file names one field
of `VVConfig` and holds every field of it that the file sets; lists
become tuples."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

CONFIGS_DIR = Path(__file__).with_name("configs")
SECTIONS = ("sam2", "propainter", "diffueraser", "infill", "mesh")


def load(name: str, directory: Path = CONFIGS_DIR) -> dict:
    return json.loads((directory / f"{name}.json").read_text())


def build(module, spec: dict):
    """`module.VVConfig` with the sections of `spec` replaced."""
    cfg = module.default_config()
    for section in SECTIONS:
        fields = spec.get(section)
        if fields is None:
            continue
        base = getattr(cfg, section)
        known = {f.name for f in dataclasses.fields(base)}
        unknown = set(fields) - known
        if unknown:
            raise ValueError(f"{section}: no such fields {sorted(unknown)}")
        values = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items()}
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(base, **values)})
    return cfg
