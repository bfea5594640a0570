"""Build the package's CUDA sources at first use and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` compiles to its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<stem>-<hash>.so <source>

The output name carries a hash of the source and flags, so an edited
source never loads a stale library, and a finished library is moved into
place atomically, so concurrent processes may race to build it.
:func:`build_all` starts one ``nvcc`` per source, all at once.  Nothing
here runs at import time: this module imports on machines without
``nvcc`` or a GPU, where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
# <repo>/build/kernels when the package runs from a checkout's src/
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC")


def sources() -> List[Path]:
    """Every CUDA source of the package, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def nvcc() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def library_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source started together; returns ``{stem: seconds}`` for the sources
    built (empty when all were present)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if not library_path(s).exists()]
    if not todo:
        return {}
    exe = nvcc()
    procs = []
    t0 = time.perf_counter()
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    times, errors = {}, []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        times[src.stem] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return times


def load(stem: str) -> ctypes.CDLL:
    """The shared library built from ``<stem>.cu`` (building every missing
    library first)."""
    match = [s for s in sources() if s.stem == stem]
    if not match:
        raise KeyError(f"no CUDA source named {stem}.cu under {KERNELS_DIR}")
    path = library_path(match[0])
    if not path.exists():
        build_all()
    return ctypes.CDLL(str(path))
