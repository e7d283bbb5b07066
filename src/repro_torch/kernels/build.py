"""Build and load the port's CUDA kernels: ``nvcc`` into plain C-ABI shared
libraries, loaded with ``ctypes``.

Every ``*.cu`` file under ``repro_torch/csrc`` is one library (the
``*.cuh`` headers there are shared by the sources that include them).  Nothing is
compiled when a module is imported: :func:`library` builds on first use,
all sources at once (one ``nvcc`` process per source, started together),
into ``build/kernels`` at the repository root.  A library's file name
carries a digest of its source and flags, so an edited source is never
served by a stale build.  The CPU path never reaches this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "SOURCE_DIR", "build_all", "library",
           "build_log"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# stem -> loaded library (a CDLL is process-global state by nature)
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(src: Path) -> Path:
    """The library's path; its digest covers the source, every shared
    header of ``csrc`` and the flags."""
    headers = b"".join(h.read_bytes()
                       for h in sorted(SOURCE_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; returns stem -> path.

    All ``nvcc`` processes start together and are waited on; the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<library>.log``.  Raises with the
    compiler's output when a source does not build.
    """
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    todo = [src for src in sources if not targets[src.stem].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            out, _ = proc.communicate()
            target = targets[src.stem]
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
                continue
            target.with_name(target.name + ".log").write_text(out)
            os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def build_log(stem: str) -> str:
    """The compiler's report for ``stem``'s current library ("" if none)."""
    log = _target(SOURCE_DIR / f"{stem}.cu")
    log = log.with_name(log.name + ".log")
    return log.read_text() if log.exists() else ""


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    lib = _LOADED.get(stem)
    if lib is None:
        path = build_all()[stem]
        lib = ctypes.CDLL(str(path))
        _LOADED[stem] = lib
    return lib
