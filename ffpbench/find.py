"""Pieces found by name: module ``name`` of the benchmark's package
``package`` (``systems``, ``delays``, ``passes``)."""
import importlib


def piece(package: str, name: str):
    if not name.isidentifier():
        raise ValueError(f"bad {package} kind {name!r}")
    return importlib.import_module(f"ffpbench.{package}.{name}")
