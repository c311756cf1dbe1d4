"""The frozen cost functions reproduce the bounds the port's bring-up
recorded (PERF.md, the table of TPU kernels: bound ms at 10,000 trials)."""
import pytest

import costs

T = 10_000


@pytest.mark.parametrize("n, want", [(32, 0.0015522770149253731), (16, 0.0007880788059701493),
                                     (8, 0.00040597970149253734)])
def test_feasibility_bound(n, want):
    assert costs.bound_ms(*costs.feasibility_cost(T, n)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("n, want", [(32, 0.07527164179104479), (16, 0.0192955223880597),
                                     (8, 0.00506268656716418)])
def test_table_build_bound(n, want):
    assert costs.bound_ms(*costs.table_cost(T, n, 3 * n, 17)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("n, want", [(32, 0.012238805970149253), (16, 0.0030686567164179106),
                                     (8, 0.0007761194029850746)])
def test_bottleneck_bound(n, want):
    assert costs.bound_ms(*costs.bottleneck_cost(T, n)) == pytest.approx(want, rel=1e-12)


def test_launch_bound_reads_the_entry_points_arguments():
    # table_build_launch(laser, ring, fsr, tr, vis, vis_ts, vis_rs, t, n, max_alias, e, ...)
    args = (1, 2, 3, 4, None, 0, 0, T, 8, 8, 24, 5, 6, 7, 0)
    assert costs.launch_bound_ms("table_build", args) == pytest.approx(0.00506268656716418)
    # feasibility_launch(laser, ring, fsr, tr_unit, s, t, n, ltd, ltc, stream)
    assert costs.launch_bound_ms("feasibility", (1, 2, 3, 4, 5, T, 32, 6, 7, 0)) == \
        pytest.approx(0.0015522770149253731)
    assert costs.launch_bound_ms("bottleneck", (1, T, 32, 2, 0)) == \
        pytest.approx(0.012238805970149253)
    assert costs.launch_bound_ms("bottleneck", (1, 2)) is None
    assert costs.launch_bound_ms("probe", (1, 2, 3, T, 1, 24, 8, 4, 5, 0)) is None
    assert costs.launch_bound_ms("match", (1, T, 8, 2, 3, 0)) is None
