"""The benchmark loads no JAX and no JAX package; the reference and the
counts load nothing of the port either."""
import json
import os
import subprocess
import sys

from bench_port_tiny import ROOT

CODE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in {names!r})))
"""


def _loaded(body, names):
    out = subprocess.run(
        [sys.executable, "-c", CODE.format(root=str(ROOT), body=body,
                                           names=names)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_and_counts_load_no_program():
    body = ("import benchmark.reference.features, benchmark.reference.models,"
            " benchmark.reference.systems, benchmark.reference.train,"
            " benchmark.reference.control, benchmark.counts.flops,"
            " benchmark.counts.kernels, benchmark.counts.peaks,"
            " benchmark.loads, benchmark.weights, benchmark.ranks")
    assert _loaded(body, ("jax", "jaxlib", "flax", "msnets_tpu",
                          "msnets_tpu_torch")) == []


def test_a_run_loads_no_jax():
    body = ("sys.path.insert(0, {d!r}); import bench_port_tiny as t; "
            "r = t.run('gcnet-train-sf', seconds=0.2); "
            "import benchmark.harness as h; assert h.forbidden_modules() == []"
            ).format(d=str(ROOT / "benchmark" / "tests"))
    loaded = _loaded(body, ("jax", "jaxlib", "flax", "msnets_tpu",
                            "msnets_tpu_torch"))
    assert loaded and all(m.split(".")[0] == "msnets_tpu_torch"
                          for m in loaded)


def test_without_a_card_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gcnet-kitti-online", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
