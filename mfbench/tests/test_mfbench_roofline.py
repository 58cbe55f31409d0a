"""The row passes' roofline counts: at a 512-voxel chunk on the padded
896 x 1024 grid that ``chip_smoke.py`` counts, they give the bounds of
the port's kernel table (kernel 2 3.898 ms, kernel 4 9.767 ms); the
metric counts the real 782 x 782 grid, a smaller bound."""

import pytest

from mfbench import roofline


@pytest.mark.parametrize("name, nx, ns, want", [
    ("rowmin3", 0, 0, 3.898), ("rowmin4", 11, 10, 9.767)])
def test_table_bounds(name, nx, ns, want):
    ms, by = roofline.bound(0, roofline.scan_ops(name, 512, 552, 896, 1024,
                                                 nx, ns))
    assert round(ms, 3) == want and by == "operations"


@pytest.mark.parametrize("name", ["rowmin3", "rowmin4"])
def test_real_grid(name):
    real = roofline.row_pass_ms(name, 512, 552, 782, 10)
    padded = roofline.bound(0, roofline.scan_ops(
        name, 512, 552, 896, 1024, *((11, 10) if name == "rowmin4"
                                     else (0, 0))))[0]
    assert 0 < real < padded
    assert real == pytest.approx(padded * 782 * 782 / (896 * 1024),
                                 rel=1e-12)
    # operations bound it: the bytes a pass reads take far less time
    b = roofline.row_pass_bytes(512, 552, 782, 782, 12)
    assert b / roofline.PEAK["bytes"] * 1e3 < real
