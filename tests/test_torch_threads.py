"""One thread in every native thread pool of a test process.

Under `pytest -n 6` each worker otherwise holds numpy's and scipy's OpenBLAS
pools and torch's OpenMP pool at one thread per core; on a few cores the
spinning OpenBLAS threads starve one another, and the host-side linear
algebra of the JAX reference solvers runs up to a hundred times slower.
pytest imports every collected module before it runs a test, so this module
pins each worker for the whole run: the variables reach the pools loaded
later and the processes the tests spawn, `threadpool_limits` the pools
already loaded, and torch is set once, before any test.  XLA's own pool is
left alone: pinning it changes its rounding.
"""

import os

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import numpy  # noqa: E402,F401  (numpy's OpenBLAS pool)
import scipy.linalg  # noqa: E402,F401  (scipy's OpenBLAS pool)
import threadpoolctl  # noqa: E402
import torch  # noqa: E402

threadpoolctl.threadpool_limits(1)
torch.set_num_threads(1)


def test_one_thread_per_native_pool():
    pools = threadpoolctl.threadpool_info()
    assert pools
    assert all(pool["num_threads"] == 1 for pool in pools), pools
    assert torch.get_num_threads() == 1
