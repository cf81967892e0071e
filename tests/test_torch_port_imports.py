"""The PyTorch port stands alone: importing it loads neither JAX nor Flax
nor any module of the JAX package, and no file of it imports them."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msnets_tpu")

PORT_MODULES = [
    "msnets_tpu_torch", "msnets_tpu_torch.config", "msnets_tpu_torch.runtime",
    "msnets_tpu_torch.ops.matchers", "msnets_tpu_torch.ops.features",
    "msnets_tpu_torch.ops.cuda._build", "msnets_tpu_torch.ops.cuda.census_aml",
    "msnets_tpu_torch.models", "msnets_tpu_torch.models.layers",
    "msnets_tpu_torch.models.gcnet", "msnets_tpu_torch.models.convert",
    "msnets_tpu_torch.serve",
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
    assert "msnets_tpu_torch.serve" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


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
