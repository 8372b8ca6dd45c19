"""The K1 bound against PERF.md's bound column for the launches the cells
make (f32, geometry compressed; the channel's wall distance one column an
element)."""

import pytest

from bench_h100 import roofline


@pytest.mark.parametrize("U,E,sgs,walls,ms", [
    (125, 4096, False, False, 0.0214), (125, 8192, False, False, 0.0428),
    (125, 4096, True, True, 0.0220)])
def test_bound_column(U, E, sgs, walls, ms):
    bound, by = roofline.k1_bound_ms(U, E, sgs=sgs, walls=walls)
    assert by == "bytes"
    assert bound == pytest.approx(ms, abs=5e-5)


def test_operations_scale_with_points_and_sgs():
    a = roofline.k1_ops(125, 100)
    assert roofline.k1_ops(125, 200) == pytest.approx(2 * a)
    assert roofline.k1_ops(125, 100, sgs=True) > a > 0
