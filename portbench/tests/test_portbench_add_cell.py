"""A cell can be added as new files alone: in a copy of the benchmark, a toy
cell (a dense GALE through the port's ``solve_gale_dense`` against SciPy's
``solve_continuous_lyapunov`` at n = 40) brings its own request kind,
storage format, problem generator, configuration, traffic, limits and
metric readers, and entries appended to ``BENCHMARK.json``.  The copy's
harness runs it, its own tests take it up, and no file that was in the copy
changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import portbench_tiny as tiny

CELL = "toy40-dense.toy-gale"

FILES = {
    "generators/toy_pencil.py": '''
        """``toy_pencil``: a dense symmetric pencil from the seed, ``E`` positive
        definite and ``A`` negative definite, and ``C (q, n)``."""

        import numpy as np


        def build(config, seed):
            n, rng = config["n"], np.random.default_rng(seed)
            G, H = rng.standard_normal((2, n, n))
            return {"E": np.eye(n) + 0.05 * G @ G.T / n, "A": -2 * np.eye(n) - H @ H.T / n,
                    "C": rng.standard_normal((config["q"], n))}
        ''',
    "formats/toy_dense.py": '''
        """``toy_dense``: the pencil as dense tensors."""

        import torch


        def operators(config, inputs, dtype, device):
            return tuple(torch.as_tensor(inputs[k], dtype=dtype, device=device) for k in "EA")
        ''',
    "kinds/toy_gale.py": '''
        """``toy_gale``: one request is one dense GALE ``AᵀXE + EᵀXA = −CᵀC``
        through the port's sign-function solver; the check solves it again with
        SciPy's Bartels–Stewart."""

        import numpy as np
        import scipy.linalg
        import torch

        from pbench import requests


        class Gale:
            def __init__(self, config, traffic, inputs, dtype, device):
                self.config, self.traffic, self.inputs = config, traffic, inputs
                self.dtype, self.device = dtype, device

            def prepare(self):
                self.E, self.A = requests.program_operators(self.config, self.inputs, self.dtype,
                                                            self.device)
                C = self.inputs["C"]
                self.rhs = torch.as_tensor(C.T @ C, dtype=self.dtype, device=self.device)
                self.run({})

            def run(self, record):
                from differentialriccatiequations_jl_tpu_torch.models import lyapunov_dense

                X = lyapunov_dense.solve_gale_dense(self.E, self.A, self.rhs,
                                                    maxiters=self.traffic["maxiters"])
                record.update(attempted=1, failed=int(not bool(torch.isfinite(X).all())),
                              sign_iters=self.traffic["maxiters"])
                return {"X": X.to("cpu", torch.float64).numpy()}

            def release(self):
                self.E = self.A = self.rhs = None

            def check(self, outputs, dtype, device):
                E, A, C = (self.inputs[k] for k in "EAC")
                M = np.linalg.solve(E.T, A.T).T
                Ct = np.linalg.solve(E.T, np.linalg.solve(E.T, C.T @ C).T).T
                X = scipy.linalg.solve_continuous_lyapunov(M.T, -Ct)
                gap = max(float(np.linalg.norm(o["X"] - X) / np.linalg.norm(X)) for o in outputs)
                return {"x_gap": gap}, {"compared": len(outputs)}


        def make(config, traffic, inputs, dtype, device):
            return Gale(config, traffic, inputs, dtype, device)


        def tiny(config, traffic):
            return dict(config, n=40), traffic


        def _altered(monkeypatch):
            from differentialriccatiequations_jl_tpu_torch.models import lyapunov_dense

            solve = lyapunov_dense.solve_gale_dense
            monkeypatch.setattr(lyapunov_dense, "solve_gale_dense",
                                lambda *a, **kw: solve(*a, **kw) * (1 + 1e-6))


        FAULTS = {"altered_answer": _altered}
        ''',
    "metrics/toy_solve_ms.py": '''
        def read(run):
            return 1e3 * run.window_s / len(run.requests) if run.requests else None
        ''',
    "metrics/toy_sign_iters.py": '''
        def read(run):
            its = [r["sign_iters"] for r in run.requests if "sign_iters" in r]
            return sum(its) / len(its) if its else None
        ''',
    "configs/toy40-dense.json": {"name": "toy40-dense", "generator": "toy_pencil",
                                 "format": "toy_dense", "n": 40, "q": 3, "dtype": "float64"},
    "traffic/toy-gale.json": {"request": "toy_gale", "maxiters": 40},
    "limits/toy40-dense.toy-gale.json": {"x_gap": {"limit": 1e-8}},
}

ENTRIES = {
    "configs": {"name": "toy40-dense", "file": "portbench/configs/toy40-dense.json",
                "source": "https://docs.scipy.org/doc/scipy/reference/generated/"
                          "scipy.linalg.solve_continuous_lyapunov.html",
                "reduced": [], "why": "a toy dense pencil"},
    "workloads": {"name": CELL, "config": "toy40-dense", "traffic": "toy-gale", "chips": 1,
                  "why": "one dense GALE a request"},
    "end_to_end": {"name": "toy_solve_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                   "source": "host_clock", "workloads": [CELL]},
    "per_layer": {"name": "toy_sign_iters", "unit": "iters", "better": "lower",
                  "source": "program_counter", "layer": "Dense GALE", "moves": "toy_solve_ms",
                  "workloads": [CELL]},
}

RUN = '''
import json, sys, time
sys.path[:0] = [sys.argv[1]]
import portbench_tiny as t
assert t.BENCH.parent.samefile(sys.argv[2]) and %r in t.CELLS
res = t.harness.run_cell(%r, 2**31 + 77, 0.2, False, t0=time.perf_counter(), device="cpu")
print(json.dumps(dict(res, forbidden=t.harness.forbidden_modules())))
''' % (CELL, CELL)


def _hashes(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_is_added_as_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(tiny.BENCH, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", copy)
    before = _hashes(copy)
    old = json.loads((copy / "BENCHMARK.json").read_text())

    for rel, body in FILES.items():
        path = copy / "portbench" / rel
        assert not path.exists(), rel
        path.parent.mkdir(exist_ok=True)
        path.write_text(json.dumps(body) if isinstance(body, dict)
                        else textwrap.dedent(body).lstrip())
    man = json.loads((copy / "BENCHMARK.json").read_text())
    for key, entry in ENTRIES.items():
        man[key].append(entry)
    (copy / "BENCHMARK.json").write_text(json.dumps(man, indent=1))

    env = dict(os.environ, PYTHONPATH=str(tiny.ROOT), PYTHONDONTWRITEBYTECODE="1",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    tests = copy / "portbench" / "tests"
    out = subprocess.run([sys.executable, "-c", RUN, str(tests), str(copy)], cwd=copy,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["x_gap"]["value"] < 1e-10
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"toy_solve_ms", "setup_s"} and res["forbidden"] == []

    # The copy's own tests take the cell up: the manifest's checks, and the
    # rehearsal, the float32 control and the kind's fault on the toy cell.
    out = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
                          "-p", "no:xdist", "-p", "no:randomly",
                          str(tests / "test_portbench_manifest.py"),
                          str(tests / "test_portbench_harness.py"), "-k", "manifest or toy"],
                         cwd=copy, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:]
    passed = [ln for ln in out.stdout.splitlines() if ln.endswith("PASSED") or " PASSED " in ln]
    for case in ("test_rehearsal[untraced-toy40", "test_rehearsal[traced-toy40",
                 "test_program_f32_control_fails[toy40", "test_fault_is_caught[altered_answer-toy40",
                 "test_cell_names_resolve_to_modules[toy40", "test_reduced_keys_are_keys_of_the_file[toy40",
                 "test_every_metric_has_a_reader[toy_sign_iters"):
        assert any(case in ln for ln in passed), case

    after = _hashes(copy)
    changed = [p for p, h in before.items() if after.get(p) != h]
    assert changed == ["BENCHMARK.json"], changed
    new = json.loads((copy / "BENCHMARK.json").read_text())
    for key, value in old.items():
        if isinstance(value, list):
            assert new[key][:len(value)] == value, key
        else:
            assert new[key] == value, key
