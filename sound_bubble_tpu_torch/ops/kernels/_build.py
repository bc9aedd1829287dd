"""Build and load the port's CUDA kernels: plain `nvcc` into a shared library
with a C interface, loaded with `ctypes`.

No PyTorch headers and no `torch.utils.cpp_extension`: each source of
`sound_bubble_tpu_torch/csrc/*.cu` is compiled by its own `nvcc` process, all
started together, and one more `nvcc` links the objects; that takes seconds,
leaves no lock file behind and cannot wait on one. The library goes to
`sound_bubble_tpu_torch/_build/libsbt_kernels.so` (listed in `.gitignore`). It
is built at first use, once per process, and never at import.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
LIB_NAME = "libsbt_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_lib = None
_build_log = ""


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands at once; (command, return code, output with the
    seconds the process took) of each. Every process is waited for, or
    killed at the time limit."""
    t0 = time.monotonic()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    deadline = t0 + NVCC_TIMEOUT_S
    outs = [""] * len(procs)
    ended = [0.0] * len(procs)

    def wait(i):   # one thread a process, so each one's own end is seen
        try:
            outs[i] = procs[i].communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            outs[i] = "[killed at the time limit]\n"
        ended[i] = time.monotonic() - t0

    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(procs))]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [(cmd, proc.returncode, f"{out}[{ended[i]:.2f} s]\n")
            for i, (cmd, proc, out) in enumerate(zip(cmds, procs, outs))]


def build() -> tuple[Path, str]:
    """Compile csrc/*.cu into BUILD_DIR/LIB_NAME, one nvcc a source in
    parallel, then link. Returns (path, compiler output incl. the
    -Xptxas -v register/shared-memory/spill lines)."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / LIB_NAME
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    # build beside the target and rename, so another process never loads a
    # half-written library
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in sources]
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    compile_cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                     "-Xcompiler", "-fPIC", "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs)]
    t0 = time.perf_counter()
    logs = []
    try:
        steps = [compile_cmds,
                 [[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]]]
        for cmds in steps:
            results = _run_all(cmds)
            logs += [f"$ {' '.join(cmd)}\n{text}[nvcc rc={rc}]"
                     for cmd, rc, text in results]
            if any(rc != 0 for _, rc, _ in results):
                raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    log = "\n".join(logs) + (f"\n[{len(sources)} sources compiled in "
                             f"parallel and linked in "
                             f"{time.perf_counter() - t0:.2f} s]")
    return out, log


def load_library() -> ctypes.CDLL:
    """Build (first call in this process) and load the kernel library."""
    global _lib, _build_log
    with _lock:
        if _lib is None:
            path, _build_log = build()
            lib = ctypes.CDLL(str(path))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.sbt_stack_walk.argtypes = (
                [ptr] * 25 + [i32] * 7 + [ctypes.c_float, ptr])
            lib.sbt_stack_walk.restype = i32
            lib.sbt_stack_walk_attn.argtypes = (
                [ptr] * 43 + [i32] * 11 + [ctypes.c_float, ptr])
            lib.sbt_stack_walk_attn.restype = i32
            for fn in (lib.sbt_stack_walk_smem, lib.sbt_stack_walk_scratch):
                fn.argtypes = [i32] * 7
                fn.restype = ctypes.c_size_t
            lib.sbt_stack_walk_clusters.argtypes = [i32] * 4
            lib.sbt_stack_walk_clusters.restype = i32
            lib.sbt_lstm_slab_fwd.argtypes = [ptr] * 10 + [i32] * 8 + [ptr]
            lib.sbt_lstm_slab_fwd.restype = i32
            lib.sbt_lstm_slab_bwd.argtypes = [ptr] * 16 + [i32] * 8 + [ptr]
            lib.sbt_lstm_slab_bwd.restype = i32
            lib.sbt_lstm_slab_bwd_smem.argtypes = [i32] * 4
            lib.sbt_lstm_slab_bwd_smem.restype = ctypes.c_size_t
            lib.sbt_blstm_seq_bwd_smem.argtypes = [i32] * 3
            lib.sbt_blstm_seq_bwd_smem.restype = ctypes.c_size_t
            lib.sbt_lstm_fwd_mixed_smem.argtypes = [i32] * 5
            lib.sbt_lstm_fwd_mixed_smem.restype = ctypes.c_size_t
            lib.sbt_lstm_fwd32_smem.argtypes = [i32] * 3
            lib.sbt_lstm_fwd32_smem.restype = ctypes.c_size_t
            lib.sbt_lstm_seq_fwd.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
            lib.sbt_lstm_seq_fwd.restype = i32
            lib.sbt_lstm_seq_bwd.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
            lib.sbt_lstm_seq_bwd.restype = i32
            lib.sbt_blstm_seq_bwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
            lib.sbt_blstm_seq_bwd.restype = i32
            lib.sbt_blstm_infer.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
            lib.sbt_blstm_infer.restype = i32
            _lib = lib
        return _lib


def build_log() -> str:
    """The compiler output of this process's build ('' before it)."""
    return _build_log
