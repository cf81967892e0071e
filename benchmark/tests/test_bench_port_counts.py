"""The yardstick's counts against hand counts."""
import pytest

from bench_port_tiny import harness
from benchmark.counts import flops, kernels, peaks

MATCHING = {"censw": 11, "nccw": 3, "sadw": 5, "sobelw": 5,
            "cens_sigma": 128.0, "ncc_sigma": 0.02, "sad_sigma": 20000.0}


def _config(name, **matching):
    return {"reference": f"systems.{name}",
            "model": {"max_disp": 32, "in_channels": 8, "base_filters": 4},
            "matching": {"ds_scale": 2, **matching}}


def test_gcnet_flops_match_a_hand_count():
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
    conf = _config("MSGCNet", board_h=12, **MATCHING)
    assert flops.forward_flops(conf, (64, 128)) == 2 * macs
    first = 27 * v[0] * f * 8
    assert flops.train_step_flops(conf, 1, (64, 128)) == \
        2 * (3 * macs - first)


def test_psmnet_counts_every_conv():
    macs = flops.serve_macs(_config("MSPSMNet", **MATCHING), (64, 128))
    # dres0 2, dres1 2, 3 hourglasses x 6, 3 classifiers x 2
    assert len(macs) == 4 + 18 + 6
    assert macs[0] == ("dres0.0.0", 16 * 32 * 64 * 4 * 8 * 27, False)
    assert all(grad_in for _, _, grad_in in macs[1:])


def test_census_bytes_are_the_least_work():
    H, W, D = 212, 644, 96
    c = kernels.census_aml(H, W, D)
    assert c["bytes"] == 2 * H * W + 2 * D * H * W * 2
    assert c["bound_by"] == "bytes"
    assert c["bound_s"] == pytest.approx(c["bytes"] / peaks.HBM_BYTES_PER_S)
    pixels, entries = kernels.valid_entries(13, 12, 8)
    assert (pixels, entries) == (2, 2)      # one valid column, d = 0 only


def test_matchers_bytes_are_the_least_work():
    """As ``chip_smoke.py`` counts them: the two images and the trimmed
    census planes read, the bf16 volume written."""
    c = kernels.matchers_aml(212, 644, 96, (10, 10, 10))
    assert c["bytes"] == 276310688 and c["bound_by"] == "bytes"
    assert c["bound_s"] == pytest.approx(0.0825e-3, rel=1e-3)
    c = kernels.matchers_aml(140, 352, 96, (6, 96, 0))
    assert c["bytes"] == 75596032
    assert c["bound_s"] == pytest.approx(0.0226e-3, rel=2e-3)


@pytest.mark.parametrize("name,census,matchers", [
    ("gcnet-kitti-online", (212, 644, 96), (212, 644, 96, (10, 10, 10))),
    ("psmnet-kitti-eval", (212, 644, 96), (212, 644, 96, (10, 10, 10))),
    ("gcnet-train-sf", (140, 352, 96), (140, 352, 96, (6, 96, 0))),
    ("gcnet-train-sf-dp4", (140, 352, 96), (140, 352, 96, (6, 96, 0)))])
def test_each_kernel_has_its_launch_shape(name, census, matchers):
    cell = harness.load_cell(name)
    assert kernels.census_launch_shape(cell) == census
    assert kernels.matchers_launch_shape(cell) == matchers
    for kernel, (count, shape) in kernels.KERNELS.items():
        assert count(*shape(cell))["bound_s"] > 0
