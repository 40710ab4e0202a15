"""Build and load the hand-written CUDA kernels (``ops/csrc``).

At first use the sources are compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, which is loaded with
``ctypes``. Each source compiles in its own ``nvcc`` process, all started
together, and one more call links them. The library lives under
``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of
the sources and the flags, so an edited source rebuilds and an unchanged
one is loaded as built. Nothing here runs at import: the CPU has no
``nvcc`` and needs none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "row_scan.cu", "masked_row_scan.cu", "gram.cu", "cross_gram.cu", "mma_rate.cu",
    "tree_eval.cu", "bsi.cu", "bsi_sum_batch.cu",
)
HEADERS = ("scan_common.cuh", "gram_tile.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libpilosa_tpu_torch_kernels.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
# C entry point -> argument types (every one returns a cudaError_t as int)
_SIGNATURES = {
    "pilosa_row_scan": (_VOIDP, _VOIDP, _INT, _INT, _INT, _INT, _VOIDP),
    "pilosa_masked_row_scan": (
        _VOIDP, _VOIDP, _VOIDP, _INT, _INT, _INT, _INT, _VOIDP,
    ),
    # the grams end with their launch plan (kernels.GramPlan)
    "pilosa_gram_gather": (
        _VOIDP, _VOIDP, _VOIDP, _INT, _INT, _INT, _INT, _INT, _VOIDP,
        _INT, _INT, _INT,
    ),
    "pilosa_cross_gram_gather": (
        _VOIDP, _LL, _LL, _VOIDP, _INT, _VOIDP, _LL, _LL, _VOIDP, _INT,
        _VOIDP, _INT, _INT, _INT, _VOIDP, _INT, _INT, _INT, _INT,
    ),
    "pilosa_mma_rate_probe": (_INT, _INT, _VOIDP, _INT, _VOIDP, ctypes.POINTER(_LL)),
    # (table, host_bytes, B, n_rows, n_steps, depth, S, W, vec16, rows_max,
    # then the plan: stages, lanes, wsplit, flat; out, device, stream)
    "pilosa_tree_count": (_VOIDP, *(_INT,) * 13, _VOIDP, _INT, _VOIDP),
    # (table, host_bytes, n_rows, n_steps, depth, S, W, vec16, out, device,
    # stream)
    "pilosa_tree_words": (_VOIDP, *(_INT,) * 7, _VOIDP, _INT, _VOIDP),
    # (table, tiles, n_rows, n_items, n_steps, L, depth, S, W, then the plan:
    # stages, rows_max, items_max, wsplit, flat; out, device, stream)
    "pilosa_tree_count_staged": (_VOIDP, *(_INT,) * 13, _VOIDP, _INT, _VOIDP),
    # (the plan's parameter block and its bytes; each operand a pointer and
    # its shard stride in words; depth, S, W, then the block shape: dmax,
    # vec, grid_x; count, out, n_out, device, stream)
    "pilosa_bsi_range": (
        _VOIDP, _INT, _VOIDP, _LL, _VOIDP, _LL, _VOIDP, _LL, *(_INT,) * 7, _VOIDP, _INT, _INT,
        _VOIDP,
    ),
    # (planes, exists, sign, filters (shard and query strides), Q, depth, S,
    # W, out, device, stream)
    "pilosa_bsi_sum": (
        _VOIDP, _LL, _VOIDP, _LL, _VOIDP, _LL, _VOIDP, _LL, _LL, *(_INT,) * 4, _VOIDP,
        _INT, _VOIDP,
    ),
    # (planes (shard and plane strides), exists, sign, filter rows (shard
    # and row strides), their index array, Q, depth, S, W, vec16, out,
    # device, stream)
    "pilosa_bsi_sum_batch": (
        _VOIDP, _LL, _LL, _VOIDP, _LL, _VOIDP, _LL, _VOIDP, _LL, _LL, _VOIDP,
        *(_INT,) * 5, _VOIDP, _INT, _VOIDP,
    ),
    # (planes, exists, sign, filter, depth, S, W, maximal, out, device, stream)
    "pilosa_bsi_extreme": (
        _VOIDP, _LL, _VOIDP, _LL, _VOIDP, _LL, _VOIDP, _LL, *(_INT,) * 4, _VOIDP, _INT,
        _VOIDP,
    ),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build in this process did: seconds, whether it compiled,
# the library path, and nvcc's own output (register and spill counts)
build_info: dict = {}


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """The CUDA compiler (``$CUDA_HOME/bin``, default ``/usr/local/cuda``,
    then ``PATH``), or ``RuntimeError`` when there is none."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = home / "bin" / "nvcc"
    if found.is_file():
        return str(found)
    which = shutil.which("nvcc")
    if which:
        return which
    raise RuntimeError(
        f"nvcc not found in {home / 'bin'} or on PATH; the CUDA kernels "
        "cannot be built"
    )


def _compile(out: Path) -> str:
    """Compile every source in parallel and link ``out``; returns nvcc's
    combined output. Raises ``RuntimeError`` with that output on failure."""
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs, failed = [], []
        for name, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {name}\n{text}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs)
            )
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib_tmp, out)
        return "\n".join(logs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def load() -> ctypes.CDLL:
    """The kernels' library, built first if this source set has no build
    yet. Thread-safe; later calls return the loaded library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        t0 = time.perf_counter()
        compiled = not path.is_file()
        log = _compile(path) if compiled else ""
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.pilosa_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pilosa_cuda_error_string.restype = ctypes.c_char_p
        build_info.update(
            seconds=time.perf_counter() - t0,
            compiled=compiled,
            path=str(path),
            log=log,
        )
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, fn: str, code: int) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.pilosa_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{fn}: CUDA error {code}: {msg}")


# tensor-core MMA opcodes in SASS: single-bit, integer, float, and the
# warpgroup forms (BGMMA, IGMMA, HGMMA, ...)
_MMA_OPCODE = re.compile(r"\b(?:BMMA|IMMA|HMMA|[A-Z]*GMMA)\b")


def sass(path: Path | None = None) -> dict[str, list[str]]:
    """The built library's SASS, by kernel (mangled name): its lines, from
    ``cuobjdump -sass`` beside ``nvcc``."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run(
        [str(cuobjdump), "-sass", str(path or library_path())],
        capture_output=True, text=True, check=True,
    ).stdout
    functions: dict[str, list[str]] = {}
    lines = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            lines = functions[m.group(1)] = []
        elif lines is not None:
            lines.append(line)
    return functions


def sass_mma_counts(functions: dict[str, list[str]]) -> dict[str, int]:
    """Tensor-core MMA instructions of each kernel of :func:`sass`."""
    return {fn: sum(len(_MMA_OPCODE.findall(line)) for line in lines)
            for fn, lines in functions.items()}
