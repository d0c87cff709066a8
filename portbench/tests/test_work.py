"""The counts of operations, bytes and launches, against hand-worked rows."""

import pytest

from portbench import work
from portbench.reference import densenet_unet


def test_decoder_conv_row():
    flop, nbytes = work.conv_work(32, 256, 256, 96, 64)
    assert flop == 2 * 32 * 256 * 256 * 9 * 96 * 64  # 231.9 GFLOP
    assert flop == pytest.approx(231.93e9, rel=1e-4)
    assert nbytes == 2 * (32 * 256 * 256 * 96 + 9 * 96 * 64
                          + 32 * 256 * 256 * 64)
    # operations bound it: 0.2345 ms at 989 TFLOP/s
    assert work.bound(flop, nbytes, "bf16") == pytest.approx(
        0.2345e-3, rel=1e-3)


def test_dense_flops_per_patch():
    assert work.model_flops(densenet_unet, 256) == pytest.approx(42.316e9,
                                                                 rel=1e-4)


@pytest.mark.parametrize("n,side", [(32, 256), (1, 4352), (2, 512)])
def test_dense_launches_match_the_program(n, side):
    """The conv kernel's launches, as the port's ``kernel_calls`` lists
    them."""
    from digipathai_tpu_torch.models import densenet_unet as port

    theirs = sorted(tuple(s[:5]) for kind, s, c in port.kernel_calls(
        n, side) for _ in range(c) if kind == "conv")
    assert sorted(work.unet_kernels("dense", n, side)) == theirs


def test_dense_batch_launches():
    assert len(work.unet_kernels("dense", 32, 256)) == 68
