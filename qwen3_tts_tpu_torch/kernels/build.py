"""Build and load the port's CUDA kernels.

`csrc/*.cu` are compiled at first use with `nvcc` for `sm_90a`, one `nvcc`
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with `ctypes`. The
library lives under `qwen3_tts_tpu_torch/kernels/_build/<hash>/`, keyed by a
hash of the sources and the compiler flags, so a changed source rebuilds and
an unchanged one is reused within a checkout. Nothing is fetched or
prebuilt. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "kernels", "_build")
LIB_NAME = "libqwen3_tts_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
# extra nvcc defines of this process's library, part of its key: the
# persistent kernels' traces (csrc/persistent.cuh kTrace) are compiled in
# only with KERNEL_TRACE, which tools/frame_measure.py sets (`trace_build`)
# before the first build of a measuring process
DEFINES: list = []

_lock = threading.Lock()
_lib = None

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a pointer passed
# without argtypes would be cut to 32 bits)
SIGNATURES = {
    # csrc/gemv.cu, gemv_int8.cu, gemv_int4.cu: ..., eps, prologue code,
    # the qk epilogue's arguments (a QkArgs, ops/gemv.py), the argmax
    # epilogue's (an ArgmaxArgs), stream
    "gemv_launch": [P, P, P, P, I, I, I, I, I, I, I, I, F, I, P, P, P],
    "gemv_int8_launch": [P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P, P,
                         P],
    "gemv_blocks_per_sm": [I, I, I, I],
    "gemv_int4_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, P,
                         P, P],
    # csrc/qmatmul.cu: (map out, q, K, N, ldq); (x, map, scale, out, M, K,
    # N, bn, mt, splits, stages, stream)
    "qmatmul_map": [P, P, I, I, I],
    "qmatmul_launch": [P, P, P, P, I, I, I, I, I, I, I, P],
    "decode_attention_launch": [P, P, P, P, P, P, P, P,
                                I, I, I, I, I, I, I, I, I, P],
    # csrc/predictor_frame.cu: (dtype, x rows a chunk, smem, int[3] out);
    # (FrameArgs, dtype, x rows a chunk, blocks, smem, stream)
    "predictor_frame_query": [I, I, I, P],
    "predictor_frame_launch": [P, I, I, I, I, P],
    # csrc/talker_step.cu: (dtype, x rows a pass, smem, int[3] out);
    # (StepArgs, dtype, x rows a pass, blocks, smem, stream)
    "talker_step_query": [I, I, I, P],
    "talker_step_launch": [P, I, I, I, I, P],
    # csrc/probes.cu (tools/mosaic_probe.py)
    "probe_hbm_scratch_launch": [P, P, P, I, P],
    "probe_fori_dma_launch": [P, P, I, P],
    "probe_argmax_launch": [P, P, I, I, I, P],
    "probe_dyn_sublane_launch": [P, P, P, P],
    "probe_rot_launch": [P, P, LL, I, P],
    "probe_onehot_launch": [P, P, P, I, I, I, I, P],
    "probe_dyn_col_dma_launch": [P, P, P, I, I, I, I, I, P],
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernels")
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + DEFINES).encode())
    return h.hexdigest()[:16]


def _run(cmds, verbose: bool) -> None:
    """Run the commands in parallel; raise with the output of a failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
        elif verbose and text:
            print(text, flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> str:
    """Compile (if needed) and return the library path."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    cu = [p for p in sources() if p.endswith(".cu")]
    # objects and library under temporary names, then a rename: a
    # concurrent build (test workers) never loads a half-written library
    tmp_dir = tempfile.mkdtemp(dir=out_dir)
    try:
        objs = [os.path.join(tmp_dir, os.path.basename(p) + ".o")
                for p in cu]
        extra = ["-Xptxas=-v"] if verbose else []
        _run([[nvcc, *NVCC_FLAGS, *DEFINES, *extra, "-c", "-o", o, p]
              for p, o in zip(cu, objs)], verbose)
        tmp_lib = os.path.join(tmp_dir, LIB_NAME)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs]], verbose)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def trace_build() -> None:
    """Make this process's library the one with the persistent kernels'
    traces compiled in (a key of its own); before the process loads one."""
    if "-DKERNEL_TRACE" in DEFINES:
        return
    if _lib is not None:
        raise RuntimeError("trace_build: the library is already loaded")
    DEFINES.append("-DKERNEL_TRACE")


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


_sms: dict = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device, which the launch plans of the cluster
    kernels (`ops/gemv.py`, `ops/flash_decode.py`) size their grids by."""
    import torch
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]
