"""The frozen roofline counts against their worked values."""

import pytest

from portbench.roofline import k4, k5, k6, k7


def test_k4_bound_at_the_chain_half_batch():
    assert k4.bytes_moved(50, 512, 15) == pytest.approx(52.47e6, rel=1e-3)
    assert k4.bound_us(50, 512, 15) == pytest.approx(15.66, rel=1e-3)


def test_k5_bound_at_the_ask_query_launch():
    assert k5.operations(256, 65536, 1024, 1000, 15) == pytest.approx(1.2217e12, rel=1e-4)
    assert k5.tensor_core_operations(256, 65536, 1024, 1000, 15) == pytest.approx(
        1.01871e12, rel=1e-4)
    assert k5.bytes_moved(256, 65536, 1024, 1024, 15) == pytest.approx(90.0e6, rel=1e-3)
    assert k5.bound_ms(256, 65536, 1024, 1000, 1024, 15) == pytest.approx(3.029, rel=1e-3)


def test_k6_bound_at_the_ask_query_launch():
    assert k6.operations(256, 65536, 15) == pytest.approx(4.0769e10, rel=1e-4)
    assert k6.bytes_moved(256, 65536, 15) == pytest.approx(1.0106e9, rel=1e-4)
    assert k6.bound_ms(256, 65536, 15) == pytest.approx(0.608, rel=1e-3)


def test_k6_kernel_name_leaves_out_k7():
    assert k6.is_kernel("void warp_kernel<float, 4>(float const*, long long)")
    assert not k6.is_kernel("void unwarp_kernel<float, 2>(float const*, long long)")


def test_k7_bound_at_the_ask_grid():
    assert k7.operations(65536, 15) == pytest.approx(9.616e9, rel=1e-4)
    assert k7.bound_ms(65536, 15) == pytest.approx(0.1435, rel=1e-3)
