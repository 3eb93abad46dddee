"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in `repro_torch/csrc/*.cu` compiles on first use into its own
shared library with a plain C interface, for `sm_90a` (Hopper), in a build
directory keyed by a hash of every source and header and of the flags.
All sources compile in parallel, one `nvcc` each, and the libraries are
loaded with `ctypes`.  The build directory is `<repo>/build/torch_kernels`
(listed in `.gitignore`).  Nothing here runs at import time: the CPU tests
import every module of the port on a machine without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("posit_codec", "paged_attention", "decode_sample")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every exported C function, by library
_SIGNATURES = {
    "posit_codec": {
        "posit_decode_launch": [_P, _P, _LL, _I, _I, _I, _P],
        "posit_encode_launch": [_P, _P, _LL, _I, _I, _I, _P],
    },
    "paged_attention": {
        "paged_attention_launch": [_P] * 10 + [_I] * 9 + [_F, _F, _P],
    },
    "decode_sample": {
        "decode_sample_tiles": [_I, _I],
        "decode_sample_launch": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _I, _P],
    },
}

_libs: dict = {}
build_log: dict = {}   # source name -> nvcc's output (the -Xptxas -v report)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build on a machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that has no library yet (in parallel); returns
    {name: path of the shared library}."""
    out_dir = _BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            build_log[name] = path.with_suffix(".log").read_text()
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True),
                      tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        stdout, stderr = proc.communicate()
        build_log[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(name)
            continue
        path.with_suffix(".log").write_text(build_log[name])
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(build_log[n] for n in failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str):
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the pointer-sized int
    the launchers take."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors):
    """Every tensor must be a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: tensors must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")
