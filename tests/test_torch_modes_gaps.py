"""test_torch_modes.py's grid in affine and linear gaps: the port's
per-read alignment (B2's and X1w's plain versions) equals the JAX package's
`_dp_full` in every mode, banded or not, with and without `-G`."""
import pytest

from test_torch_modes import assert_per_read_equals_jax, grid


@pytest.mark.parametrize("gap,mode,banded,ps", grid("affine") + grid("linear"))
def test_per_read_modes_equal_jax_dp_full(gap, mode, banded, ps):
    assert_per_read_equals_jax(gap, mode, banded, ps)
