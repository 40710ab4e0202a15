"""Build-on-demand loader for the port's native C++ libraries
(counterpart of ``pilosa_tpu/nativelib.py``).

A source under ``pilosa_tpu_torch/native/`` is compiled with ``g++`` on
first use into ``build/native/<hash>/`` at the root of the checkout, keyed
by a hash of the source, the flags and the host's CPU (its architecture
and feature flags), so an edited source rebuilds, an unchanged one is
loaded as built, and a checkout copied to another machine never loads a
``-march=native`` build made for a CPU with other instructions. Unlike
the JAX package's loader there is no Python fallback and no switch to
force one: where the library cannot be built or loaded, :func:`load`
raises, so no serving path goes on in numpy without saying so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable

NATIVE_SRC = Path(__file__).resolve().parent / "native"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "native"
# ``-march=native`` first (popcnt/AVX on x86); plain -O3 for toolchains
# that reject it
FLAG_SETS = (
    ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native"),
    ("-O3", "-std=c++17", "-shared", "-fPIC"),
)


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def _cpu_tag() -> str:
    """The host's architecture and CPU feature flags (the first ``flags``
    or ``Features`` line of ``/proc/cpuinfo`` where there is one)."""
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return tag + line
    except OSError:
        pass
    return tag + platform.processor()


def lib_path(src: Path) -> Path:
    """Where ``src`` builds: ``build/native/<hash of source, flags and
    CPU>/``."""
    h = hashlib.sha256()
    h.update(repr(FLAG_SETS).encode())
    h.update(_cpu_tag().encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{src.stem}.so"


def build(src: Path, out: Path) -> None:
    """Compile ``src`` into ``out`` atomically, or raise
    :class:`NativeBuildError` with the compiler's last words.

    The object is written to a PER-PROCESS temp name and ``os.replace``'d
    in: processes building at once (parallel test workers) each produce a
    complete library and the last rename wins; a shared temp name would
    interleave their output into a corrupt one."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(f"g++ not found on PATH; cannot build {src.name}")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    errors = []
    try:
        for flags in FLAG_SETS:
            try:
                subprocess.run(
                    [cxx, *flags, str(src), "-o", tmp],
                    check=True, capture_output=True, text=True, timeout=120,
                )
            except subprocess.CalledProcessError as e:
                errors.append(e.stderr.strip()[-2000:])
                continue
            except (OSError, subprocess.SubprocessError) as e:
                errors.append(str(e))
                continue
            os.replace(tmp, out)
            return
        raise NativeBuildError(f"g++ could not build {src.name}: {errors[-1]}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Load ``native/<name>`` (building it when its hashed library is
    absent) and bind its entry points with ``bind``. Raises
    :class:`NativeBuildError` when the source cannot be built or the
    library lacks an entry point. Callers cache the result under their
    own lock."""
    src = NATIVE_SRC / name
    out = lib_path(src)
    if not out.is_file():
        build(src, out)
    try:
        lib = ctypes.CDLL(str(out))
        bind(lib)
    except (OSError, AttributeError) as e:
        raise NativeBuildError(f"cannot load {out}: {e}") from e
    return lib
