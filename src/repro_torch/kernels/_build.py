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
# (query/key head dim, value head dim) pairs that K1's dispatches in
# csrc/flash_attention.cu and its backward's in csrc/flash_attention_bwd.cu
# instantiate: 80 for zamba2, 256 for gemma3, (192, 128) for deepseek-v2's
# multi-head latent attention
FLASH_HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128),
                   (256, 256), (192, 128))
# head dims of K2's dispatch switches in csrc/decode_attention.cu
DECODE_HEAD_DIMS = (16, 32, 64, 80, 128, 256)

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


def aligned16(sizes, strides, ptr: int, itemsize: int) -> bool:
    """Whether a tensor of these sizes and (element) strides at address
    ``ptr`` can be read in 16-byte pieces along its last dimension: unit
    stride there, every other stride a whole number of 16 bytes, a 16-byte
    aligned base.  A dimension of size 1 never moves the address, so its
    stride does not count.  The rule of K1-K4's 16-byte loads
    (8 bf16 or 4 float32 elements)."""
    if ptr % 16:
        return False
    *outer, last = zip(sizes, strides)
    if last[0] != 1 and last[1] != 1:
        return False
    return all(n == 1 or (st * itemsize) % 16 == 0 for n, st in outer)


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a layout the kernels' 16-byte loads take (:func:`aligned16`);
    anything else is copied to a contiguous tensor (a fresh allocation is
    always aligned)."""
    ok = aligned16(x.shape, x.stride(), x.data_ptr(), x.element_size())
    return x if ok else x.contiguous()


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``NotImplementedError`` (naming ``what``: the kernel and the
    ROADMAP item that brings its backward) where autograd would need a
    backward kernel that the port does not have: grad enabled and an input
    that requires it.  The wrappers call it for CUDA tensors only; on the
    CPU autograd runs through their plain versions."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"no backward kernel on the card: {what}")


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of each C entry point: without them ctypes would pass
# pointers as 32-bit ints
ARGTYPES = {
    # q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv, strides, causal, window,
    # dtype, stream
    "fate_flash_attention": [_P] * 5 + [_I32] * 7 + [_I64] * 12 + [_I32] * 3
    + [_P],
    # q, k, v, o, dout, lse, delta, dq_accum, counters, dq, dk, dv, B, Sq,
    # Sk, H, KV, D, Dv, causal, window, dtype, stream
    "fate_flash_attention_bwd": [_P] * 12 + [_I32] * 10 + [_P],
    # ..., B, H, KV, D, S, cache_len_dev, cache_len, chunk, nsplit, ...
    "fate_decode_attention": [_P] * 8 + [_I32] * 5 + [_P] + [_I32] * 3
    + [_I64] * 10 + [_I32] + [_P],
    "fate_moe_gemm": [_P] * 3 + [_I32] * 5 + [_I64] * 10 + [_I32] * 2 + [_P],
    # x, dy, dw, B, E, C, D, F, x strides, dy strides, dtype, vector, stream
    "fate_moe_gemm_dw": [_P] * 3 + [_I32] * 5 + [_I64] * 8 + [_I32] * 2
    + [_P],
    # a, b, out, B, E, C, D, F, a strides, b strides, layout, grid,
    # row_tiles, col_tiles, k_stages, stream
    "fate_moe_gemm_grad": [_P] * 3 + [_I32] * 5 + [_I64] * 6 + [_I32] * 5
    + [_P],
    # ..., dtype, out_dtype, stream
    "fate_rwkv6_scan": [_P] * 8 + [_I32] * 5 + [_I64] * 15 + [_I32] * 2
    + [_P],
    # r, k, v, w, bonus, state0, dout, dstate, states, dstates, factors,
    # dr, dk, dv, dw, dbonus_part, dbonus, dstate0, B, S, H, D, L, strides,
    # dtype, passes, stream
    "fate_rwkv6_scan_bwd": [_P] * 18 + [_I32] * 5 + [_I64] * 15
    + [_I32] * 2 + [_P],
    "fate_mamba2_scan": [_P] * 8 + [_I32] * 6 + [_I64] * 13 + [_I32] * 2
    + [_P],
    # x, b, c, dt, a_log, state0, dy, dstate, states, dstates, factors, dx,
    # ddt, db_part, dc_part, da_part, db, dc, da_log, dstate0, B, S, H, P,
    # N, L, strides, dtype, passes, stream
    "fate_mamba2_scan_bwd": [_P] * 20 + [_I32] * 6 + [_I64] * 13
    + [_I32] * 2 + [_P],
}


def declare(lib: ctypes.CDLL, names=None) -> None:
    """Set ``restype`` and ``argtypes`` of the entry points ``names`` (all
    of :data:`ARGTYPES` if None) on ``lib``."""
    for name in names or ARGTYPES:
        fn = getattr(lib, name)
        fn.restype = _I32
        fn.argtypes = ARGTYPES[name]


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        declare(lib)
        _lib = lib
    return _lib
