"""The port (its ``parallel/`` layer, parareal and the row-sharded steps
included), `chip_smoke.py` and `profile_steps.py` import no JAX, and CPU
tensors never reach kernels K1 and K2; the row-sharded Ros1 step and a
block-ELL shard's products run over a one-rank gloo group without JAX.

Runs in a subprocess with ``jax`` blocked in ``sys.modules`` (the test
process itself has JAX loaded by the conftest).
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import differentialriccatiequations_jl_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke, profile_steps  # noqa: F401,E401  (their work runs only under __main__)
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
               for m, v in sys.modules.items() if v is not None)
assert "differentialriccatiequations_jl_tpu" not in sys.modules

import torch
from differentialriccatiequations_jl_tpu_torch.kernels import bell_spmm as k2
from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil, shifted_bell
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate
E, A, _, _ = rail_surrogate(100)
E_op, _ = dia_pencil(E, A, device="cpu")  # _ is A's operator
X = torch.ones((100, 3), dtype=torch.float64)
E_op.mm(X); E_op.tmm(X); E_op.mmT(X.T); E_op.mmT_axpby(X.T, X.T, 2.0, 1.0)
assert k1.launches == 0, k1.launches
bE, bA = bell_pencil(E, A, bs=16, device="cpu")
F = shifted_bell(bE, bA, -1.0)
F.mm(X); F.tmm(X); F.mm(X[:, 0]); F.tmm(X.T.contiguous().T)
assert k2.launches == 0, k2.launches
from differentialriccatiequations_jl_tpu_torch.lowrank import lowrank, lr_zero
from differentialriccatiequations_jl_tpu_torch.models.residuals import residual_gare_lowrank
from differentialriccatiequations_jl_tpu_torch.utils.callbacks import notify
residual_gare_lowrank(E_op, E_op, lowrank(X[:, :2]), lowrank(X),
                      lr_zero(100, 4, torch.float64, device="cpu"))
notify(None, "gare_start", None, None)
assert k1.launches == 0, k1.launches
assert not torch.backends.cuda.matmul.allow_tf32
from differentialriccatiequations_jl_tpu_torch import (
    ADI, GALEProblem, GAREProblem, GDREProblem, Newton, Ros1, Ros2, Shifts, init,
    lowrank, lr_norm, residual, solve)
from differentialriccatiequations_jl_tpu_torch.models.compiled import CompiledConfig
C1 = torch.as_tensor(np.ones((100, 1)))
gale = GALEProblem(E_op, _, lowrank(C1))
X = solve(gale, ADI(shifts=Shifts.Cyclic(Shifts.Heuristic(4, 6, 6))))
assert float(residual(gale, X).D.abs().max()) < 1e-8
init(gale, ADI()).step()
solve(GDREProblem(E_op, _, C1, C1.T, lowrank(C1), (1.0, 0.0)), Ros2(), dt=-0.5)
solve(GAREProblem(E_op, _, lowrank(C1), lowrank(C1)), Newton(maxiters=2))
assert k1.launches == 0, k1.launches
from differentialriccatiequations_jl_tpu_torch import BartelsStewart, Kronecker, Ros4
from differentialriccatiequations_jl_tpu_torch.models.compiled import build_step_shift_solvers
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate_dense
Ed, Ad, Bd, Cd = rail_surrogate_dense(12, device="cpu")
dgale = GALEProblem(Ed, Ad, Cd.T @ Cd)
for alg in (BartelsStewart(), BartelsStewart(host=True), Kronecker()):
    assert float(torch.linalg.norm(residual(dgale, solve(dgale, alg)))) < 1e-10
solve(GDREProblem(Ed, Ad, Bd, Cd, Cd.T @ Cd, (1.0, 0.0)), Ros4(), dt=-0.5)
build_step_shift_solvers(dgale.E, dgale.A, np.asarray([-1.0, -2.0 + 1.0j, -2.0 - 1.0j]))
import dataclasses
from differentialriccatiequations_jl_tpu_torch import GMRES, Krylov, solve_blocklinear
from differentialriccatiequations_jl_tpu_torch.models.compiled import (
    CappedADI, build_dia_shift_ops, default_dia_krylov, solve_gare_newton_compiled)
X = solve(gale, GMRES(maxiters=2, maxrestarts=1, warn_convergence=False,
                      preconditioner=ADI(maxiters=2, shifts=Shifts.Cyclic((-1.0,)))))
assert float(residual(gale, X).D.abs().max()) < float(lr_norm(gale.C) ** 2)
F = E_op.adjoint()
for alg in (Krylov(method="gmres", restart=5, maxiter=2),
            Krylov(solve_dtype="float32", refine_iters=1)):
    assert solve_blocklinear(F, X.L[:, :2], alg).shape == (100, 2)
ops = build_dia_shift_ops(E_op, _, np.asarray([-1.0]), dataclasses.replace(
    default_dia_krylov(torch.float64, False), solve_dtype="float32"))
assert ops.prec_inv.dtype == torch.float32
are = GAREProblem(E_op, _, lowrank(C1), lowrank(C1))
solve_gare_newton_compiled(are, shifts=np.asarray([-1.0]), cfg=CompiledConfig(4, 2, 8),
                           capacity=16, maxiters=1, inner_solve_dtype="float32")
solve_gare_newton_compiled(are, shifts=np.asarray([-1.0]), cfg=CompiledConfig(4, 2, 8),
                           capacity=16, maxiters=1, inner_gmres=GMRES(
                               maxiters=2, warn_convergence=False,
                               preconditioner=CappedADI(2, 8, 16)))
solve(are, Newton(GMRES(maxiters=2, warn_convergence=False), maxiters=1))
assert k1.launches == 0, k1.launches
from differentialriccatiequations_jl_tpu_torch import Parareal, lr_with_capacity
from differentialriccatiequations_jl_tpu_torch.parallel.mesh import shard_operator
sol = solve(GDREProblem(E_op, _, C1, C1.T, lr_with_capacity(lowrank(C1), 8), (2.0, 0.0)),
            Parareal(slabs=2, max_iters=1), dt=-0.5, shifts=np.asarray([-1.0]),
            cfg=CompiledConfig(4, 2, 8), capacity=8)
assert sol.parareal_info["iterations"] == 1 and len(sol.K) == 5
Y = torch.ones((100, 3), dtype=torch.float64)
sh = shard_operator(None, E_op, rank=1, world=2)
sh.local_mm(sh.extend(Y)); sh.local_mm(sh.extend(Y), t=True)
sb = shard_operator(None, bE, rank=0, world=2)
sb.local_mm(sb.extend(Y)); sb.local_mm(sb.extend(Y[:, 0]), t=True)
assert k1.launches == 0 and k2.launches == 0, (k1.launches, k2.launches)
from differentialriccatiequations_jl_tpu_torch import __version__, config
from differentialriccatiequations_jl_tpu_torch.ops import prepare_shifted
from differentialriccatiequations_jl_tpu_torch.parallel import dryrun
assert config.default_dtype() == torch.float64 and callable(prepare_shifted)
import torch.distributed as dist
from differentialriccatiequations_jl_tpu_torch.parallel.mesh import (
    collectives, make_mesh, use_mesh)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{dryrun.free_port()}",
                        world_size=1, rank=0)
mesh = make_mesh(1, "cpu")
X, K, iters, res, _ = dryrun.ros1_step_sharded(torch.device("cpu"), 256, mesh)
sb = shard_operator(mesh, bE)
with use_mesh(mesh):
    for got, ref in ((sb.mm(Y), bE.mm(Y)), (sb.tmm(Y), bE.tmm(Y))):
        assert torch.allclose(got, ref, rtol=1e-14, atol=0.0)
del sb, mesh  # nothing holds the group past its end
dist.destroy_process_group()
assert iters > 0 and collectives["all_reduce"] > 0 and collectives["halo_exchange"] > 0
assert k1.launches == 0, k1.launches
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
               for m, v in sys.modules.items() if v is not None)
print("OK", len(names))
"""


def test_port_imports_no_jax_and_cpu_never_launches():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 35  # every module was imported


def test_no_jax_import_statements():
    files = sorted((ROOT / "differentialriccatiequations_jl_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "profile_steps.py"]
    for path in files:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            assert words[:2] not in (["import", "jax"], ["from", "jax"]), path
            assert not line.strip().startswith(("import jax", "from jax")), path
