"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o build/<name>-<hash>.so <name>.cu

`--fmad=false` keeps nvcc from contracting `x * a + b` into an FMA, and
`--use_fast_math` is never used: the kernels' epilogues must round exactly
like their plain PyTorch versions.  Libraries go into the repository's
`build/` directory (git-ignored), named by a hash of the sources, so a
changed kernel is rebuilt and an unchanged one is reused.  ptxas's
register / shared-memory report lands in `build/<name>-<hash>.log`.

Nothing here runs at import: `library(name)` builds on first use, and
`build_all()` starts one nvcc per source at once (what chip_smoke.py calls
before it drives the model).  `COUNTS` holds each kernel's launch count:
a wrapper adds one where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("conv_pe", "conv_pe_f", "conv_pe_w4", "dwc_pe", "flash_attn",
           "low_channel", "misc_pe", "paged_gather")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

COUNTS: Dict[str, int] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_counts() -> None:
    COUNTS.clear()


def count(kernel: str) -> None:
    COUNTS[kernel] = COUNTS.get(kernel, 0) + 1


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    the one on PATH."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _target(name)
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish(out: Path, tmp: Path, proc) -> None:
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)


def build_all() -> Dict[str, Path]:
    """Compile every missing library, one nvcc per source, all at once."""
    jobs = [_start(n) for n in SOURCES if not _target(n).exists()]
    for job in jobs:
        _finish(*job)
    return {n: _target(n) for n in SOURCES}


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use.  `bind`
    declares argtypes / restype once, when the library is loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                _finish(*_start(name))
            lib = ctypes.CDLL(str(out))
            bind(lib)
            _libs[name] = lib
        return lib


def check(err: int, kernel: str) -> None:
    """Raise on a launch the runtime refused (cudaGetLastError != 0)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    """The wrapper's checks on a kernel operand: device, dtype, shape,
    contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def ptr(t) -> int:
    """Device pointer of an optional operand (None -> NULL)."""
    return None if t is None else t.data_ptr()


# csrc/epilogue.cuh's Act codes.  Every kernel on that header applies the
# BASIC_ACTS; tanh-gelu only the int8 Conv PE's GEMM (csrc/conv_pe.cu act4,
# bitwise with torch's CUDA F.gelu(approximate="tanh")): its wrapper passes
# GEMM_ACTS, every other wrapper refuses gelu.
ACT_CODES = {"none": 0, "relu": 1, "relu6": 2, "gelu": 3}
BASIC_ACTS = ("none", "relu", "relu6")
GEMM_ACTS = BASIC_ACTS + ("gelu",)


def act_code(act: str, have=BASIC_ACTS) -> int:
    if act not in have:
        raise ValueError(f"activation {act!r} has no CUDA epilogue here "
                         f"(have {sorted(have)})")
    return ACT_CODES[act]


# the float GEMM's epilogue (csrc/conv_pe_f.cu) applies every act of
# ref.act_fn, in f32
F_ACT_CODES = {"none": 0, "relu": 1, "relu6": 2, "relu2": 3, "silu": 4,
               "gelu": 5, "hardswish": 6}


def f_act_code(act: str) -> int:
    if act not in F_ACT_CODES:
        raise ValueError(f"activation {act!r} has no float GEMM epilogue "
                         f"(have {sorted(F_ACT_CODES)})")
    return F_ACT_CODES[act]
