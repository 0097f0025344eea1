"""Build and load the hand-written CUDA kernels; count their launches.

Every source in ``csrc/`` exposes a plain C launcher (``extern "C"``,
pointers and ints in, the launch's ``cudaError_t`` out) and includes no
PyTorch header, so the build takes seconds. ``load_kernels()`` compiles all
of them at first use into one shared library under ``_build/`` (listed in
``.gitignore``) for ``sm_90a``, without ``--use_fast_math`` (its
flush-to-zero would break the codec's byte-exactness):

* with ``ninja`` present, in ONE ``torch.utils.cpp_extension.load`` call
  (ninja compiles the sources in parallel, and ``load`` links the result as
  a plain shared library);
* otherwise, or when ``REPRO_TORCH_BUILDER=nvcc`` asks for it, with one
  ``nvcc`` per source, all started together, and an ``nvcc -shared`` link.

Either way the library is opened with ``ctypes`` and the wrappers call the
same launchers. Nothing here runs at import time: the CPU tests import every
module of the port on a machine with no ``nvcc``. Processes that share one
build directory (the kv ranks of sequence-sharded pools) build it once in
the parent and open it with ``load_kernels(build=False)``.

Launch accounting: each wrapper calls ``count_launch`` where it launches its
kernel. A CUDA graph's replay runs none of that Python, so a graph's capture
records its launches (``record_launches``) instead of counting them (a
capture runs no kernel), and each replay adds the record
(``add_launches``): ``launch_counts()`` stays the count of kernels run.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterator, Optional

import torch

__all__ = ["load_kernels", "launch_counts", "reset_launch_counts", "count_launch",
           "check_launch", "record_launches", "add_launches", "stream_ptr", "KERNEL_NAMES", "BUILD_DIR", "build_seconds",
           "builder"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(os.environ.get(
    "REPRO_TORCH_BUILD_DIR", pathlib.Path(__file__).resolve().parent / "_build"))
SOURCES = ("mx_quant.cu", "mx_dequant.cu", "mx_dequant_reduce.cu", "paged_attention.cu")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]
LIB_NAME = "repro_torch_kernels"

KERNEL_NAMES = ("mx_quant", "mx_dequant", "mx_dequant_reduce", "paged_attention")
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
_RECORD: Optional[Dict[str, int]] = None   # the open capture's record, if any

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "mxk_quant": [_P, _I, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _I, _I, _P],
    "mxk_dequant": [_P, _P, _P, _I, _P, _I, _LL, _I, _I, _I, _P],
    "mxk_dequant_reduce": [_P, _P, _P, _I, _P, _I, _LL, _I, _I, _I, _I, _P],
    "mxk_paged_attention": [_P] * 14 + [_I] * 14 + [_F, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_build_s: Optional[float] = None
_builder: Optional[str] = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """One launch of ``name``: counted, or recorded while a capture is open."""
    target = _LAUNCHES if _RECORD is None else _RECORD
    target[name] = target.get(name, 0) + 1


@contextlib.contextmanager
def record_launches() -> Iterator[Dict[str, int]]:
    """Within the block, launches go into the yielded record instead of the
    counters: wrap a graph's capture in it, and ``add_launches(record)`` at
    each replay."""
    global _RECORD
    outer, record = _RECORD, {}
    _RECORD = record
    try:
        yield record
    finally:
        _RECORD = outer


def add_launches(record: Dict[str, int]) -> None:
    """Count the launches of one replay of a graph whose capture gave ``record``."""
    for name, n in record.items():
        _LAUNCHES[name] += n


def check_launch(name: str, err: int) -> None:
    """Raise if the launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def build_seconds() -> Optional[float]:
    """Wall seconds the first ``load_kernels()`` call spent building."""
    return _build_s


def builder() -> Optional[str]:
    """Which path built the library: ``"load"`` or ``"nvcc"``."""
    return _builder


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else (shutil.which("nvcc") or "nvcc")


def _build_with_load() -> pathlib.Path:
    from torch.utils.cpp_extension import load

    load(name=LIB_NAME, sources=[str(CSRC / s) for s in SOURCES],
         build_directory=str(BUILD_DIR), extra_cuda_cflags=NVCC_FLAGS,
         is_python_module=False, verbose=False)
    return BUILD_DIR / f"{LIB_NAME}.so"


def _build_with_nvcc() -> pathlib.Path:
    nvcc = _nvcc()
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD_DIR / (pathlib.Path(src).stem + ".o")
        objs.append(str(obj))
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC", "-c", str(CSRC / src),
             "-o", str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out.decode(errors='replace')}")
    lib = BUILD_DIR / f"{LIB_NAME}.so"
    res = subprocess.run([nvcc, "-shared", *objs, "-o", str(lib)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout.decode(errors='replace')}")
    return lib


def load_kernels(build: bool = True) -> ctypes.CDLL:
    """Build (first call only) and open the kernel library; with
    ``build=False`` open the library an earlier build left in ``BUILD_DIR``
    (raising if there is none) without compiling."""
    global _lib, _build_s, _builder
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a GPU (torch.cuda.is_available() is False)")
    from torch.utils.cpp_extension import is_ninja_available

    t0 = time.perf_counter()
    use_load = is_ninja_available() and os.environ.get("REPRO_TORCH_BUILDER") != "nvcc"
    if build:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        (BUILD_DIR / "lock").unlink(missing_ok=True)  # left by a build that was cut off
        path = _build_with_load() if use_load else _build_with_nvcc()
    else:
        path = BUILD_DIR / f"{LIB_NAME}.so"
        if not path.exists():
            raise RuntimeError(f"no kernel library at {path}: call load_kernels() first")
        use_load = None
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _build_s = time.perf_counter() - t0
    _builder = {True: "load", False: "nvcc", None: "prebuilt"}[use_load]
    _lib = lib
    return lib
