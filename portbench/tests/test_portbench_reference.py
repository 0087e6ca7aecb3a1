"""The plain reference against the port at n = 371 on the CPU, and its
independence: it imports nothing of the program."""

import ast
import math

import numpy as np
import pytest
import torch

import portbench_tiny as tiny
from pbench import reference, requests

PORT = "differentialriccatiequations_jl_tpu_torch"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "surrogate.py"):
        tree = ast.parse((tiny.BENCH / "pbench" / name).read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                mods.add((node.module or "").split(".")[0])
        assert mods <= {"__future__", "math", "numpy", "scipy", "torch"}, mods


def _inputs():
    config, _, _ = tiny.tiny("rail79841-dia.ros1-sweep")
    return requests.build_inputs(config, tiny.SEED)


def test_block_cholesky_solves_the_shifted_matrix():
    inp = _inputs()
    P = reference.Pencil(inp["E"], inp["A"], inp["B"], inp["C"])
    chol = reference.ShiftedCholesky(P.A, P.E, 1.0, -0.05, [-0.3, -2.0])
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal((P.n, 3)))
    for s, p in enumerate(chol.shifts):
        M = -(inp["A"] + (p - 0.05) * inp["E"]).toarray()
        x = chol.solve(s, rhs)
        assert float(np.abs(M @ x.numpy() - rhs.numpy()).max()) < 1e-12


def test_wachspress_shifts_lie_in_the_interval():
    sh = reference.wachspress_shifts(0.01, 3.0, 12)
    assert all(-3.0 <= p <= -0.01 for p in sh) and len(set(sh)) == 12


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_reference_agrees_with_the_port(cell):
    config, traffic, limits = tiny.tiny(cell)
    inputs = requests.build_inputs(config, tiny.SEED)
    req = requests.make(config, traffic, inputs, torch.float64, "cpu")
    req.prepare()
    out = req.run({})
    numbers, notes = req.check([out], torch.float64, "cpu")
    for k, v in numbers.items():
        assert math.isfinite(v) and v <= limits[k]["limit"], (k, v, notes)
