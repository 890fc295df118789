"""The frozen roofline counts against their worked values."""

import pytest

from portbench.roofline import k4, k5


def test_k4_bound_at_the_chain_half_batch():
    assert k4.bytes_moved(50, 512, 15) == pytest.approx(52.47e6, rel=1e-3)
    assert k4.bound_us(50, 512, 15) == pytest.approx(15.66, rel=1e-3)


def test_k5_bound_at_the_ask_query_launch():
    assert k5.operations(256, 65536, 1024, 1000, 15) == pytest.approx(1.2217e12, rel=1e-4)
    assert k5.tensor_core_operations(256, 65536, 1024, 1000, 15) == pytest.approx(
        1.01871e12, rel=1e-4)
    assert k5.bytes_moved(256, 65536, 1024, 1024, 15) == pytest.approx(90.0e6, rel=1e-3)
    assert k5.bound_ms(256, 65536, 1024, 1000, 1024, 15) == pytest.approx(3.029, rel=1e-3)
