"""The operations and bytes counted from shapes."""

import math

import pytest
import torch

from gpubench import roofline


def test_distinct_draws_against_a_count():
    gen = torch.Generator().manual_seed(0)
    draws = torch.randint(0, 5000, (20, 3000), generator=gen)
    seen = sum(len(torch.unique(row)) for row in draws) / 20
    assert roofline.distinct_draws(3000, 5000) == pytest.approx(seen, rel=0.01)
    assert roofline.distinct_draws(0, 10) == 0.0 and roofline.distinct_draws(5, 1) == 1.0


def test_a_sync_epoch_launch_by_hand():
    # 2 steps x 1 worker x 4 rows of 3 entries from a pool of 10; sgd with
    # dim_sparsity: w in and out, dim_sparsity in; 2 operations a feature a step
    rows = 10 * (1 - (1 - 1 / 10) ** 8)
    w = roofline.sync_epoch_launch(2, 1, 4, 3, 100, 10, 0, True, 2)
    assert w.bytes == pytest.approx(rows * (3 * 8 + 4) + 8 * 8 + 3 * 4 * 100)
    assert w.flops == 4 * 3 * 8 + 2 * 100 * 2
    adam = roofline.sync_epoch_launch(2, 1, 4, 3, 100, 10, 2, False, 16)
    assert adam.bytes - w.bytes == pytest.approx((2 * 2 - 1) * 4 * 100)


def test_the_main_shape_is_bound_by_bytes_at_a_quarter_gigabyte():
    w = roofline.sync_epoch_launch(2146, 3, 100, 76, 47236, 215723, 0, True, 2)
    assert w.bound_by() == "bytes"
    assert 2.4e8 < w.bytes < 2.7e8 and w.least_seconds() == w.bytes / roofline.HBM_BYTES_PER_S


def test_an_evaluation_and_sums_of_work():
    e = roofline.evaluation(1000, 76, 47236)
    assert e.bytes == 1000 * (76 * 8 + 4) + 4 * 47236 and e.flops == 2 * 76 * 1000 + 4 * 1000
    both = e + e * 2
    assert both.bytes == 3 * e.bytes and math.isclose(both.flops, 3 * e.flops)
