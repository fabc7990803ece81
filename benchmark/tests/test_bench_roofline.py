"""The yardstick's arithmetic reproduces the least times that
chip_smoke.py printed at the main-path shapes (PERF.md's kernel table):
gradients 0.3433 / 0.0215 ms, rollout 0.0586 / 0.0037 ms, the env rollout
with obs 0.3050 ms; and the mfu's flop an iteration."""

import pytest

from benchmark import roofline


def ms(x):
    return round(x * 1e3, 4)


def test_gradient_bounds():
    assert ms(roofline.grads_seconds(32, 32768, 1)) == 0.3433
    assert ms(roofline.grads_seconds(1, 65536, 1)) == 0.0215
    # launches add up
    assert roofline.grads_seconds(32, 32768, 40) == pytest.approx(
        40 * roofline.grads_seconds(32, 32768, 1))


def test_rollout_bounds():
    assert ms(roofline.policy_rollout_seconds(32, 1024, 16, 1, 200)) == 0.0586
    assert ms(roofline.policy_rollout_seconds(1, 2048, 16, 1, 20)) == 0.0037


def test_env_bound():
    # ~100,000 episode ends in a headline launch
    assert ms(roofline.env_rollout_seconds(262144, 256, 1, 100_000)) == 0.3050


def test_mfu_flop():
    # P = 32: 4,194,304 env-steps an iteration
    assert roofline.train_flop(32, 1024, 128, 10, 1) == pytest.approx(
        4194304 * (18432 + 10 * 54016))
    assert roofline.MFU_PEAK_FLOP_PER_S == 495e12
