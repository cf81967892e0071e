"""Build and load the port's CUDA kernels (the counterpart of the JAX
package's ``ops/pallas/`` folder).

Each ``msnets_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``build/msnets_tpu_torch/`` beside the package, at first use. The file
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one is loaded as it is. Libraries are loaded with
``ctypes``; the wrappers in this folder declare each C function's argument
types (pointers and the stream as ``c_void_p``).

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "msnets_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's default

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    if DEFAULT_NVCC.is_file():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels are built on the GPU machine)")


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _flags(defines: Sequence[str]) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to; keyed by the source, the shared
    headers of ``csrc/``, the flags and the ``-D`` defines (such as
    ``MSN_PHASES=1``, census_common.cuh)."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for p in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          defines: Sequence[str] = ()) -> Dict[str, dict]:
    """Compile the named kernels (all of ``csrc/`` by default) that are not
    built yet, with ``defines``, one ``nvcc`` per source, all started
    together.

    Returns ``{name: {"path", "seconds", "log"}}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, spills) for each library built here.
    Raises ``RuntimeError`` with the compiler's output if any build fails."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        src, dst = CSRC_DIR / f"{name}.cu", library_path(name, defines)
        if not src.is_file():
            raise FileNotFoundError(src)
        if dst.is_file():
            out[name] = {"path": str(dst), "seconds": 0.0, "log": "cached"}
            continue
        tmp = dst.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [find_nvcc(), *_flags(defines), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, dst, tmp, proc, time.perf_counter()))
    failed = []
    for name, dst, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, dst)      # atomic: a concurrent loader sees all or nothing
        out[name] = {"path": str(dst), "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu`` (with ``defines``), built
    first if needed."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        path = Path(build([name], defines)[name]["path"])
        lib = _LIBS[key] = ctypes.CDLL(str(path))
    return lib
