"""The traffic generator: the same seed gives the same inputs, another
seed other inputs with the same sizes; every serving size pads to the one
bucket the cell warms."""
import numpy as np
import pytest

from bench_port_tiny import harness
from benchmark import loads

SERVING = ("kitti-online", "kitti-stream")


@pytest.mark.parametrize("mix", SERVING)
def test_serving_mix_is_the_seeds(mix):
    spec = loads.load(mix)
    spec.update(pool=3)
    a, b, c = (loads.Serving(spec, s) for s in (2**31 + 5, 2**31 + 5, 8))
    assert [a.request(i) for i in range(40)] == [b.request(i)
                                                  for i in range(40)]
    assert all(np.array_equal(x, y) for x, y in zip(a.pair(3), b.pair(3)))
    assert not np.array_equal(a.pairs[0][0], c.pairs[0][0])
    # every seed sends the same sizes in the same proportions
    block = sum(n for _, _, n in spec["sizes"])
    for t in (a, c):
        sizes = sorted((h, w) for _, h, w in (t.request(i)
                                              for i in range(block)))
        assert sizes == sorted((h, w) for h, w, n in spec["sizes"]
                               for _ in range(n))
    assert sorted(a.shapes) == [(370, 1226), (374, 1238), (375, 1242),
                                (376, 1241)]
    assert {harness.bucket_of(h, w, 32) for h, w in a.shapes} == {(384, 1248)}


def test_pairs_follow_their_disparity():
    r = np.random.default_rng(3)
    left, right, d = loads.slanted_pair(r, 20, 300, 0, 190)
    assert left.dtype == right.dtype == np.uint8 and d.min() >= 0
    assert d.max() <= 190
    y, x = 10, 250
    k = int(round(d[y, x]))
    if abs(d[y, x] - k) < 1e-6 and x - k >= 0:
        assert left[y, x] == right[y, x - k]


def test_train_mix_shapes_and_seed():
    spec = loads.load("sceneflow-train")
    spec.update(pool=2)
    a, b = (loads.Training(spec, s, (12, 192, 0)) for s in (5, 5))
    c = loads.Training(spec, 6, (12, 192, 0))
    x = a.batches[0]
    assert x["iml"].shape == (2, 280, 704) and x["iml"].dtype == np.uint8
    assert x["disp"].shape == (2, 256, 512) and x["disp"].dtype == np.float32
    assert (x["board_h"], x["board_w_left"], x["board_w_right"]) == (12, 192,
                                                                     0)
    assert np.array_equal(x["iml"], b.batches[0]["iml"])
    assert not np.array_equal(x["iml"], c.batches[0]["iml"])
    assert not np.array_equal(a.batches[0]["iml"], a.batches[1]["iml"])
