"""Files found by name: ``portbench/<folder>/<name>.py``, loaded from its
path.  One helper for every part of a cell that a name in
``BENCHMARK.json`` or in a cell's files picks: a metric's reader
(``metrics/``), a traffic file's request kind (``kinds/``), a
configuration's storage format (``formats/``) and its problem generator
(``generators/``).  A new part is a new file, and no code names it."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


class Missing(FileNotFoundError, ValueError):
    """No file for a name: a ``ValueError`` to the callers that report a
    bad cell, a ``FileNotFoundError`` to those that look for a file."""


def load(folder: str, name: str):
    """The module of ``<folder>/<name>.py`` under the benchmark's directory;
    raises `Missing`, naming the file, where there is none."""
    path = BENCH / folder / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise Missing(f"no file {folder}/{name}.py for {name!r} in {BENCH}")
    tag = re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
