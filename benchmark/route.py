"""Code found by name: what is specific to one kind of optic, defect,
source or request sits in a module of its own, ``benchmark/<package>/<kind>.py``,
which a configuration or a traffic file names. A new kind joins as a new
file, and no file the harness already has is edited."""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")


def module(package: str, name: str):
    """``benchmark/<package>/<name>.py``, imported as part of the package."""
    if not _NAME.match(str(name)):
        raise ValueError(f"{package} kind {name!r} is not a module name")
    try:
        return importlib.import_module(f"benchmark.{package}.{name}")
    except ModuleNotFoundError as exc:
        if exc.name != f"benchmark.{package}.{name}":
            raise
        raise ValueError(f"no {package} kind {name!r}: benchmark/{package}/{name}.py "
                         "is not there") from None
