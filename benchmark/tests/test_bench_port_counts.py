"""The yardstick's counts against hand counts."""
import pytest

from benchmark.counts import flops, kernels, peaks


def test_gcnet_flops_match_a_hand_count():
    mc = {"name": "MS-GCNet", "max_disp": 32, "in_channels": 8,
          "base_filters": 4}
    D, H, W = 16, 32, 64                     # the half-res volume
    v = [D * H * W >> (3 * i) for i in range(5)]   # voxels at each scale
    f = 4
    conv = (v[0] * f * 8 + v[0] * f * f                       # stem
            + v[1] * 2 * f * f + 2 * v[1] * 4 * f * f         # block 1
            + 3 * v[2] * 4 * f * f + 3 * v[3] * 4 * f * f     # blocks 2, 3
            + v[4] * 4 * f * 2 * f + 2 * v[4] * 16 * f * f)  # block 4
    deconv = (v[4] * 4 * f * 2 * f + v[3] * 4 * f * f + v[2] * 4 * f * f
              + v[1] * 2 * f * f + v[0] * f)          # input voxels x Cin x Cout
    macs = 27 * (conv + deconv)
    got = flops.forward_flops(mc, {"ds_scale": 2}, 1, (64, 128))
    assert got == 2 * macs
    first = 27 * v[0] * f * 8
    assert flops.train_step_flops(mc, {"ds_scale": 2}, 1, (64, 128)) == \
        2 * (3 * macs - first)


def test_psmnet_counts_every_conv():
    mc = {"name": "MS-PSMNet", "max_disp": 32, "in_channels": 8,
          "base_filters": 4}
    macs = flops.conv_macs(mc, (1, 8, 16, 32, 64))
    # dres0 2, dres1 2, 3 hourglasses x 6, 3 classifiers x 2
    assert len(macs) == 4 + 18 + 6
    assert macs[0] == ("dres0.0.0", 16 * 32 * 64 * 4 * 8 * 27)


def test_census_bytes_are_the_least_work():
    H, W, D = 212, 644, 96
    c = kernels.census_aml(H, W, D)
    assert c["bytes"] == 2 * H * W + 2 * D * H * W * 2
    assert c["bound_by"] == "bytes"
    assert c["bound_s"] == pytest.approx(c["bytes"] / peaks.HBM_BYTES_PER_S)
    pixels, entries = kernels.valid_entries(13, 12, 8)
    assert (pixels, entries) == (2, 2)      # one valid column, d = 0 only
