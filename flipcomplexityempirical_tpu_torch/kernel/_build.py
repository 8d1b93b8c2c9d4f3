"""Build the package's CUDA sources with nvcc on first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, loaded with ``ctypes``: seconds per source, where a build
against PyTorch's headers takes minutes. The library's file name carries
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already built. Libraries go to
``build/cuda/`` beside the package (``FCE_TORCH_BUILD_DIR`` overrides),
which git ignores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: dict = {}


def build_dir() -> Path:
    env = os.environ.get("FCE_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "cuda"


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temporary output, final output, log path)."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return None, None, out, log
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, log


def _finish(name: str, proc, tmp: Path, out: Path, log: Path) -> None:
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
    os.replace(tmp, out)


def build_all(names=None) -> dict:
    """Compile every named source (default: all of ``csrc/*.cu``) with one
    nvcc process each, all started together. Returns {name: (library
    path, compiler log)}."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {nm: _start(nm) for nm in names}
    result = {}
    for nm, (proc, tmp, out, log) in started.items():
        if proc is not None:
            _finish(nm, proc, tmp, out, log)
        text = log.read_text() if log.exists() else ""
        result[nm] = (out, text)
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
