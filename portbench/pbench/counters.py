"""The program's counters: every numeric module-level value of the port's
loaded modules (``kernels.dia_spmm.launches``,
``ops.blocklinear.krylov_iterations``, ``models.compiled.shift_rebuild_seconds``,
...), read as deltas around each request, so a metric over a new counter
needs no change to the harness."""

from __future__ import annotations

import sys

PORT = "differentialriccatiequations_jl_tpu_torch"


def snapshot() -> dict:
    """``{"<module>.<name>": value}`` for the port's numeric module globals
    (numbers, and dicts of numbers flattened as ``<name>.<key>``); private
    and upper-case names are left out."""
    out = {}
    for modname, mod in list(sys.modules.items()):
        if mod is None or not (modname == PORT or modname.startswith(PORT + ".")):
            continue
        short = modname[len(PORT) + 1:] or PORT
        for key, val in list(vars(mod).items()):
            if key.startswith("_") or key.isupper() or isinstance(val, bool):
                continue
            if isinstance(val, (int, float)):
                out[f"{short}.{key}"] = val
            elif isinstance(val, dict) and val and all(
                    isinstance(v, (int, float)) and not isinstance(v, bool) for v in val.values()):
                for k, v in val.items():
                    out[f"{short}.{key}.{str(k).replace('torch.', '')}"] = v
    return out


def delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def add(total: dict, part: dict) -> dict:
    out = dict(total)
    for k, v in part.items():
        out[k] = out.get(k, 0) + v
    return out
