"""The page pool's half of `tests/test_torch_scheduler.py`'s matrix: the
port's `ContinuousBatchingScheduler` over `PagedEngine` (page size 16,
where the JAX entry runs XLA, and 128, its Pallas kernels) against the JAX
package's, bf16 and int8 pools, the window path and the chunk ladder,
pipelined or not: identical greedy deliveries and finish order, every
step's top-2 margin above LOGIT_TOL, and both pools free at the end.  A
file of its own, so that the suite's workers share the matrix.
"""

import pytest

from tests.test_torch_scheduler import MATRIX, check_matrix_case


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


@pytest.mark.parametrize(**MATRIX)
@pytest.mark.parametrize("page_size", [16, 128])
def test_paged_scheduler_matches_jax(page_size, kv_quantized, window,
                                     pipeline, monkeypatch):
    check_matrix_case(page_size, kv_quantized, window, pipeline, monkeypatch)
