"""Configurations from a configuration file's fields, for the program
(``surtr_tpu_torch``) or the reference (``plainref``): the same fields on
both sides."""

from __future__ import annotations

import importlib


def fracture(package: str, fields: dict):
    return importlib.import_module(package + ".config").FractureConfig(**fields)


def scene(package: str, fields: dict):
    c = importlib.import_module(package + ".config")
    return c.SceneConfig(fracture=c.FractureConfig(**fields["fracture"]),
                         physics=c.PhysicsConfig(**fields["physics"]),
                         render=c.RenderConfig(**fields["render"]))
