"""A cell's parts, found by name: each is a module in a folder of its own
under ``bench_port/``, loaded from its file.

* ``scenes/<generator>.py``: ``arrays(spec) -> dict``, a configuration's
  ``scene`` block as the raw input arrays.
* ``samplers/<kind>.py``: ``draw(sampling, render, gen, device) -> (cam,
  bounce)``, one frame's uniforms under a workload's ``sampling`` block.
* ``jobs/<job>.py``: ``Job``, what one unit of the window is and how its
  outputs are checked, and optionally ``build(config, arrays, dev)`` where
  the job hands the port its inputs otherwise than ``program.build``.
* ``metrics/<metric>.py``: ``read(trace) -> float | None``.

A later cell that needs a new one adds a file and edits none.
"""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
FOLDERS = ("scenes", "samplers", "jobs", "metrics")


@functools.lru_cache(maxsize=None)
def load(folder: str, name: str, base: Path = HERE):
    """The module ``base``/``folder``/<name>.py (loaded once)."""
    if folder not in FOLDERS:
        raise ValueError(f"no folder {folder!r} of parts")
    path = Path(base) / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} part {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{folder}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
