"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc`, all started together,
and the objects are linked into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not the minutes of
`torch.utils.cpp_extension.load`). The library
lands in `ntrace_tpu_torch/_build/` under a name keyed by a hash of the
sources and flags, is built at first use, and is reused while the sources
are unchanged. A failed build or load raises: there is no fallback.

Flags: `sm_90a` (Hopper), C++17, -O3, and `--fmad=false` because the
traversal kernel promises bit-equality with its torch twin and with
`brute_force_mt`; FMA contraction would break it. `--use_fast_math` is
never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers / local memory per kernel, into the log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (restype, argtypes). Pointers and the stream are
# c_void_p (a bare Python int would be cut to 32 bits), ints are c_int.
_TRAVERSAL = (ctypes.c_int,
              [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P])
SIGNATURES = {
    # packet_trace.cu, packet_ww.cu, packet_ifif.cu: one signature
    # (csrc/trace_common.cuh NTRACE_TRAVERSAL_ENTRY).
    "ntrace_packet_trace": _TRAVERSAL,
    "ntrace_packet_ww": _TRAVERSAL,
    "ntrace_packet_ifif": _TRAVERSAL,
    "ntrace_dense_walk": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "ntrace_dense_dma": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "ntrace_row_scan_tile": (ctypes.c_int, []),
    "ntrace_row_scan_i32": (
        ctypes.c_int,
        [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P],
    ),
}


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # nvcc wall time; 0.0 when the library already existed
    log: str         # nvcc's output (ptxas register / spill report)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libntrace_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands at once; (return code, output) of each. Every
    process is ended before this returns, on error too."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def build() -> Build:
    """Compile csrc/*.cu unless the hashed library exists; raises on failure."""
    path = library_path()
    if path.exists():
        return Build(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources()]
    tmp = path.with_name(f"{stem}.tmp.so")
    t0 = time.perf_counter()
    try:
        done = _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                         for s, o in zip(sources(), objs)])
        log = "".join(out for _, out in done)
        if all(rc == 0 for rc, _ in done):
            done = _run_all([[nvcc(), *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
            log += done[0][1]
        seconds = time.perf_counter() - t0
        bad = [rc for rc, _ in done if rc != 0]
        if bad:
            raise RuntimeError(f"nvcc failed ({bad[0]}):\n{log}")
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return Build(path, seconds, log)


_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), signatures bound."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib
