"""Build and load the CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, which is loaded with
``ctypes``.  Nothing is built when the module is imported: the first
call of :func:`load` compiles (one ``nvcc`` per source file, started
together, then one link) into ``build/repro_torch/<hash of the sources>``
under the repository root, and later calls in any process find the library
there.  A build or a load that
fails raises; there is no other implementation to fall back to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libfate_kernels.so"

# conventions of the C interface, shared by the wrappers
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0      # wall time of the build this process made


def sources() -> list[Path]:
    """The ``.cu`` files that make up the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every file under ``csrc/`` and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_root() -> Path:
    """Directory that holds the builds (listed in ``.gitignore``)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME``, the ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $PATH and /usr/local/cuda): "
        "the CUDA kernels cannot be built on this machine")


def build() -> Path:
    """Compile the library if this source hash has not been built yet;
    return its path.  The log of ``ptxas -v`` (registers, shared memory,
    spills per kernel) is kept beside it as ``build.log``."""
    global build_seconds
    out_dir = build_root() / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then move it into place, so that a
    # process that finds the library finds it whole
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir.parent))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs = [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{text}")
            objs.append(str(obj))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp / LIB_NAME), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log) + link.stdout)
        try:
            tmp.rename(out_dir)
        except OSError:
            if not lib_path.is_file():   # not a lost race: a real failure
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a layout the kernels' 4-element loads take: unit stride
    in the last dimension, every other stride a multiple of 4 elements and
    a 16-byte aligned base.  Anything else is copied to a contiguous
    tensor (a fresh allocation is always aligned)."""
    ok = (x.stride(-1) == 1
          and all(s % 4 == 0 for s in x.stride()[:-1])
          and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


def _declare(lib: ctypes.CDLL) -> None:
    """Set ``argtypes``: without them ctypes would pass pointers as
    32-bit ints."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fate_flash_attention.restype = i32
    lib.fate_flash_attention.argtypes = (
        [ptr] * 4 + [i32] * 6 + [i64] * 12 + [i32] * 3 + [ptr])
    lib.fate_decode_attention.restype = i32
    lib.fate_decode_attention.argtypes = (
        [ptr] * 7 + [i32] * 7 + [i64] * 10 + [i32] + [ptr])
    lib.fate_moe_gemm.restype = i32
    lib.fate_moe_gemm.argtypes = (
        [ptr] * 3 + [i32] * 5 + [i64] * 10 + [i32] + [ptr])
    lib.fate_rwkv6_scan.restype = i32
    lib.fate_rwkv6_scan.argtypes = (
        [ptr] * 8 + [i32] * 5 + [i64] * 15 + [i32] + [ptr])


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib
