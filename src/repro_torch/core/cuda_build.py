"""Build and load the CUDA kernels: those that ``core/codegen_cuda.py``
emits, and the hand-written ones under ``csrc/`` (:func:`csrc_launcher`).

Each kernel is one ``.cu`` file with a plain C entry point, compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library and loaded with
``ctypes`` — no PyTorch headers, so one build takes seconds.  Libraries go
to ``build/repro_torch/`` under the checkout (or ``$REPRO_TORCH_BUILD_DIR``),
named by a hash of the source, the headers and the flags, so an unchanged
kernel is built once and a changed one can never load a stale library.
:func:`build_many` runs one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC")

#: counters the serving engine pins: sources built by nvcc, and seconds
STATS = {"builds": 0, "build_s": 0.0}


def build_dir() -> Path:
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if root:
        return Path(root)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda)")


def source_key(source: str) -> str:
    h = hashlib.sha256()
    h.update(source.encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def library_path(key: str) -> Path:
    return build_dir() / f"k_{key}.so"


def _start(source: str, key: str):
    out = library_path(key)
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = out.with_suffix(".cu")
    cu.write_text(source)
    # build to a private name, then rename: concurrent builders of the
    # same kernel never see a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def build_many(sources: Sequence[Tuple[str, str]]) -> List[Path]:
    """Build every ``(key, source)`` whose library is missing, one
    ``nvcc`` process each, all started together.  Raises on the first
    compiler error, with its output."""
    todo: Dict[str, str] = {}
    for key, src in sources:
        if not library_path(key).exists():
            todo[key] = src
    t0 = time.perf_counter()
    procs = [_start(src, key) for key, src in todo.items()]
    errors = []
    for proc, tmp, out, cmd in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
            Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    STATS["builds"] += len(procs)
    STATS["build_s"] += time.perf_counter() - t0
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return [library_path(key) for key, _ in sources]


#: ``argtypes`` of the emitted kernels' launcher ``int symbol(void** ptrs,
#: const long long* strides, int inst0, int inst1, void* stream)``
EMITTED_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p)


class Launcher:
    """The C launcher ``symbol`` of the library built from ``source``: it
    returns a ``cudaError_t`` code as an int.  Built and loaded on first
    use; each accepted launch adds one to ``launches``, and to
    ``shapes[shape]`` where the caller names its ``shape``."""

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence = EMITTED_ARGTYPES,
                 what: Optional[str] = None):
        self.source, self.symbol = source, symbol
        self.argtypes = tuple(argtypes)
        self.what = what or symbol
        self.key = source_key(source)
        self.launches = 0
        self.shapes: Counter = Counter()
        self._fn = None

    @property
    def loaded(self) -> bool:
        return self._fn is not None

    def build(self) -> None:
        if self._fn is None:
            build_many([(self.key, self.source)])
            lib = ctypes.CDLL(str(library_path(self.key)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            fn.keepalive = lib
            self._fn = fn

    def launch(self, *args, shape: Optional[str] = None) -> None:
        """Call the launcher (the caller passes the stream among ``args``)
        and raise if the launch was refused."""
        self.build()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"launch of {self.what} failed with "
                               f"cudaError {rc}")
        self.launches += 1
        if shape is not None:
            self.shapes[shape] += 1


def csrc_launcher(file: str, symbol: str, argtypes: Sequence) -> Launcher:
    """The launcher of the hand-written kernel ``csrc/<file>``."""
    return Launcher((CSRC / file).read_text(), symbol, argtypes,
                    what=f"{symbol} ({file})")
