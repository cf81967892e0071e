"""The PyTorch port stands alone: importing it loads neither JAX nor Flax
nor msgpack nor any module of the JAX package, and no file of it imports
them (the reader of JAX checkpoints, engine/flax_msgpack.py, decodes with
the standard library)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "msnets_tpu")

PORT_MODULES = [
    "msnets_tpu_torch", "msnets_tpu_torch.config", "msnets_tpu_torch.runtime",
    "msnets_tpu_torch.ops.matchers", "msnets_tpu_torch.ops.features",
    "msnets_tpu_torch.ops.cuda._build", "msnets_tpu_torch.ops.cuda.census",
    "msnets_tpu_torch.ops.cuda.census_aml",
    "msnets_tpu_torch.models", "msnets_tpu_torch.models.layers",
    "msnets_tpu_torch.models.gcnet", "msnets_tpu_torch.models.convert",
    "msnets_tpu_torch.serve", "msnets_tpu_torch.engine",
    "msnets_tpu_torch.engine.loss", "msnets_tpu_torch.engine.trainer",
    "msnets_tpu_torch.engine.checkpoint", "msnets_tpu_torch.data",
    "msnets_tpu_torch.data.pfm", "msnets_tpu_torch.data.resolvers",
    "msnets_tpu_torch.data.pipeline", "msnets_tpu_torch.models.psmnet",
    "msnets_tpu_torch.engine.evaluator", "msnets_tpu_torch.utils",
    "msnets_tpu_torch.utils.colormap", "msnets_tpu_torch.utils.summary",
    "msnets_tpu_torch.cli", "msnets_tpu_torch.parallel",
    "msnets_tpu_torch.parallel.mesh", "msnets_tpu_torch.parallel.halo",
    "msnets_tpu_torch.engine.flax_msgpack", "msnets_tpu_torch.data.png",
    "msnets_tpu_torch.experiments", "msnets_tpu_torch.experiments.cross_domain",
    "msnets_tpu_torch.experiments.synthetic_smoke",
    "msnets_tpu_torch.utils.profiling", "msnets_tpu_torch.utils.debug_viz",
    "msnets_tpu_torch.models.basic_blocks", "msnets_tpu_torch.ops.sampling",
    "msnets_tpu_torch.models.quant", "msnets_tpu_torch.ops.cuda.int8_conv3d",
    "msnets_tpu_torch.ops.cuda.int8_quantize",
]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import importlib, json, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(PORT_MODULES) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []
    # the card's machine has no OpenCV: the data pipeline, the evaluator
    # and the colour maps import it lazily, as the summaries do tensorboardX
    assert "cv2" not in loaded
    assert "tensorboardX" not in loaded
    assert "matplotlib" not in loaded


def _sources():
    return sorted((ROOT / "msnets_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"
