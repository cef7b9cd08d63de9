"""`align_windows` against the JAX package's `align_windows_jax` on the
one-window reads of `-S -n 200` (sim2k's reads 2-4, each one window from
the source to the sink: at k = 19 they share no chained anchor), in
linear, affine and convex gaps, tolerance 0; the multi-window cases are in
test_torch_windows.py, whose helpers this file uses.
"""
import pytest

from test_torch_windows import GAPS, check_reads_2_to_4


@pytest.mark.parametrize("gap", list(GAPS))
def test_one_window_reads_equal_jax(gap):
    assert check_reads_2_to_4("n200", gap) == [1, 1, 1]
