"""Build and load the package's CUDA kernels.

Each ``*.cu`` file here is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, in ``BUILD_DIR``
(``build/stylex_tpu_torch/`` at the root of the checkout, unless
``utils.cache`` moved it), named by a hash of its source, the shared
headers (``*.cuh``) and the flags: a changed source builds anew, an
unchanged one is loaded as built. Missing libraries are built in parallel,
one ``nvcc`` per source, all started together. Nothing is compiled or
loaded when this module is imported.

Each C entry point returns ``cudaGetLastError()`` after its launch, and
takes the argument types ``ARGTYPES`` gives its kernel. The resampling
kernels' (``upsample2x_bilinear``, ``blur3``, ``blur3_downsample2x``) are
``int fn(const void* x, void* y, int planes, int h, int w, int vec, int
blocks, int device, void* stream)``, where ``h`` and ``w`` are the input's
size, ``vec`` the columns of a thread's segment and ``blocks`` the grid of
256-thread blocks (both from ``ops.blur.launch_geometry``). The
convolution's column kernels (``im2col``, ``col2im``) are ``int fn(const
void* src, void* dst, const ColumnsArgs* args, int device, void*
stream)``, the geometry in :class:`ColumnsArgs` (``columns.cuh``'s struct,
filled by ``ops.conv``); their shared tiles are ``TILE_FLOATS`` and
``GATHER_FLOATS`` floats, given to ``nvcc`` as defines. The classifiers'
batch norm (``frozen_bn``) is ``int fn(const void* y, const void* residual,
void* out, const void* mean, const void* scale, const void* bias, long long
n, int c, int hw, int act, int aligned, int device, void* stream)``
(``residual`` null for none; ``hw`` 1 for channels-last; the grid sized
in the source). Kernel names that share a source share its one library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["ARGTYPES", "DEFINES", "GATHER_FLOATS", "KERNELS", "TILE_FLOATS", "ColumnsArgs",
           "build", "load", "library_path"]

_HERE = Path(__file__).resolve().parent
DEFAULT_BUILD_DIR = _HERE.parents[1] / "build" / "stylex_tpu_torch"
# where libraries are built and loaded from; utils.cache may move it
BUILD_DIR = DEFAULT_BUILD_DIR

# kernel name -> (source file, exported C functions)
KERNELS: Dict[str, tuple] = {
    "upsample2x_bilinear": ("upsample2x_bilinear.cu",
                            ("upsample2x_bilinear_f32", "upsample2x_bilinear_bf16")),
    "blur3": ("blur3.cu", ("blur3_f32", "blur3_bf16")),
    "blur3_downsample2x": ("blur3.cu", ("blur3_downsample2x_f32", "blur3_downsample2x_bf16")),
    "im2col": ("im2col.cu", ("im2col_f32",)),
    "col2im": ("col2im.cu", ("col2im_f32",)),
    "frozen_bn": ("frozen_bn.cu", ("frozen_bn_f32", "frozen_bn_bf16")),
}

# the column kernels' shared tiles, in floats: im2col's input tile and
# col2im's tile of position-major columns (ops.conv sizes the tiles to them)
TILE_FLOATS = 4096
GATHER_FLOATS = 12288
DEFINES = (f"-DTILE_FLOATS={TILE_FLOATS}", f"-DGATHER_FLOATS={GATHER_FLOATS}")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", *DEFINES,
)


class ColumnsArgs(ctypes.Structure):
    """``columns.cuh``'s ``ColumnsArgs``, field for field: the image (n, c,
    h, w) as ``planes`` = n * c, its strides ``xs_*`` and the columns'
    ``gs_*`` in elements, the window (``kh``, ``kw``), stride, padding and
    output size, a block's tile (``pb`` channels, ``ti`` rows, ``tj``
    columns), im2col's stores of ``vec`` and col2im's unrolled windows per
    axis (``vec``)."""

    _fields_ = [(name, ctypes.c_int64) for name in (
        "planes", "c", "h", "w", "xs_n", "xs_c", "xs_h", "xs_w", "gs_n", "gs_k", "gs_l",
        "kh", "kw", "sh", "sw", "ph", "pw", "oh", "ow", "pb", "ti", "tj", "vec", "blocks")]


_PLANES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_COLUMNS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ColumnsArgs), ctypes.c_int,
            ctypes.c_void_p]
_FROZEN_BN = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]

# kernel name -> the argument types of its C functions
ARGTYPES: Dict[str, list] = {"upsample2x_bilinear": _PLANES, "blur3": _PLANES,
                             "blur3_downsample2x": _PLANES, "im2col": _COLUMNS,
                             "col2im": _COLUMNS, "frozen_bn": _FROZEN_BN}

_loaded: Dict[str, ctypes.CDLL] = {}  # kernel name -> its source's library
_libraries: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` (its source's) is or will be built:
    named by a hash of the source, the shared headers and the flags."""
    src = _HERE / KERNELS[name][0]
    headers = b"".join(h.read_bytes() for h in sorted(_HERE.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None, verbose: bool = False) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, all in parallel.

    Returns kernel name -> library path. Raises ``RuntimeError`` with the
    compiler's output if any build fails. ``verbose`` prints what ``nvcc``
    reports (registers, shared memory, spills for each kernel).
    """
    names = list(KERNELS if names is None else names)
    paths = {n: library_path(n) for n in names}
    # one build per missing library, whatever the number of kernels in it
    todo = {paths[n]: KERNELS[n][0] for n in names if not paths[n].exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for path, src in todo.items():
        # build to a private name, then rename: a concurrent build never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_HERE / src)]
        procs.append((path, src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for path, src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src}: nvcc exited {proc.returncode}\n{out}")
            os.unlink(tmp)
            continue
        os.replace(tmp, path)
        if verbose:
            print(f"[nvcc {src}]\n{out.strip()}", flush=True)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _libraries.get(path) or ctypes.CDLL(str(path))
        _libraries[path] = _loaded[name] = lib
        for fn in KERNELS[name][1]:
            getattr(lib, fn).argtypes = ARGTYPES[name]
            getattr(lib, fn).restype = ctypes.c_int
    return lib
