"""Build the package's CUDA sources at first use and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` compiles to its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<stem>-<hash>.so <source>

The output name carries a hash of the source and flags, so an edited
source never loads a stale library, and a finished library is moved into
place atomically, so concurrent processes may race to build it.
:func:`build_all` starts one ``nvcc`` per source, all at once.  A source
may also be built with a *prelude*, C++ text that ``nvcc -include``s
before it (a custom loss's step for ``sdca_block.cu``): such a library
carries the prelude in its hash and is built beside the others when
:func:`build_all` (or :func:`load`, at first use) is handed it.  Nothing
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
from typing import Dict, List, Sequence, Tuple

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


def library_path(src: Path, prelude: str = "") -> Path:
    digest = hashlib.sha1(src.read_bytes() + repr(NVCC_FLAGS).encode()
                          + prelude.encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _start(exe: str, src: Path, prelude: str = ""):
    """Start ``nvcc`` on ``src`` (after ``prelude``, written beside the
    library); returns (src, library, temporary output, process)."""
    out = library_path(src, prelude)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    if prelude:
        head = out.with_suffix(".prelude.cuh")
        head.write_text(prelude)
        cmd[1:1] = ["-include", str(head)]
    return src, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT)


def _finish(procs, t0: float) -> Dict[str, float]:
    """Wait for ``_start``'s builds and move each library into place;
    returns ``{name: seconds}``, raising with nvcc's log on a failure."""
    times, errors = {}, []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        name = src.stem if out == library_path(src) else f"{src.stem}+prelude"
        times[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return times


def build_all(extra: Sequence[Tuple[str, str]] = ()) -> Dict[str, float]:
    """Compile every source whose library is missing, and each (stem,
    prelude) of ``extra`` whose library is, one ``nvcc`` per library
    started together; returns ``{name: seconds}`` for the libraries built
    (empty when all were present; a prelude's named ``<stem>+prelude``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    by_stem = {s.stem: s for s in sources()}
    todo = [(s, "") for s in sources()] + [(by_stem[stem], head)
                                           for stem, head in extra]
    todo = [(s, head) for s, head in todo
            if not library_path(s, head).exists()]
    if not todo:
        return {}
    exe = nvcc()
    t0 = time.perf_counter()
    return _finish([_start(exe, src, head) for src, head in todo], t0)


def load(stem: str, prelude: str = "") -> ctypes.CDLL:
    """The shared library built from ``<stem>.cu``, after ``prelude`` when
    one is given (building every missing library first)."""
    match = [s for s in sources() if s.stem == stem]
    if not match:
        raise KeyError(f"no CUDA source named {stem}.cu under {KERNELS_DIR}")
    path = library_path(match[0], prelude)
    if not path.exists():
        build_all([(stem, prelude)] if prelude else ())
    return ctypes.CDLL(str(path))
