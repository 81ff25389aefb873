"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``deeplearning4j_tpu_torch/csrc/<name>.cu`` is compiled on its own by
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC --split-compile=0`` into
``build/torch_kernels/<name>-<hash>.so`` at the
root of the checkout (git-ignored). The hash covers the source, the
shared headers and the flags, so an edited source rebuilds at its next
use and an unchanged one loads the library already built. A build that
fails raises with nvcc's stderr. Every build passes ``-Xptxas -v``
(which does not change the binary) and keeps nvcc's stderr, the ptxas
register / spill report of each kernel instance, beside the library as
``<name>-<hash>.log`` (`ptxas_report`); `sass_mma_counts` counts each
instance's tensor-core instructions in the built library.

Libraries are built at first use (`load`), never at import: the CPU
tests import every module of the package on machines with no nvcc.
`build_all` starts one nvcc per source at once, for callers that want
every kernel ready up front (the chip smoke run). ``--split-compile=0``
lets nvcc optimise a source's many template instances on all cores:
on an 8-core H100 host it cut the parallel build of the three sources
from 114.4 s to 40.0 s (flash_bwd.cu alone from 119.7 s to 35.5 s).

`ensure_built(*srcs, cache=)` takes a compile cache (any object with
`fetch_library` / `publish_library`, as `serving.compile_cache.
CompileCache`; the serving engine passes its ``compile_cache_dir``'s):
a library missing from the build directory is asked of it before nvcc
is; the cache checks its entry's CRC before the bytes are written
atomically to `library_path` (and so before any dlopen), and deletes a
corrupt entry, which nvcc then rebuilds. Every library nvcc builds, or
finds built, is published into it. `nvcc_runs` counts this process's nvcc runs
by source and `origin` says where each library came from ("nvcc",
"cache" or "disk", the build directory). A failed build still raises:
there is no eager fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
              "-Xptxas", "-v"]

# element-type codes of the C interface (csrc/common.cuh DType); the
# one-byte codes name a quantized KV cache's values
DTYPE_F32, DTYPE_F16, DTYPE_BF16, DTYPE_I8, DTYPE_E4M3 = 0, 1, 2, 3, 4

# name -> C entry point and its argument types (pointers and the stream
# as c_void_p, so no pointer is ever cut to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_fwd": ("dl4j_flash_fwd",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                   _I, _P]),
    "flash_bwd": ("dl4j_flash_bwd",
                  [_P] * 10 + [_I] * 5 + [_F, _I, _I, _I, _P]),
    "decode_attention": ("dl4j_decode_attention",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                          _I, _I, _P]),
    "decode_window": ("dl4j_decode_window",
                      [_P, _P, _P, _P, _P] + [_I] * 7 + [_F, _I, _I, _P]),
    "lstm_scan": ("dl4j_lstm_scan", [_P] * 11 + [_I] * 7 + [_P]),
    "flash_bwd_packed2": ("dl4j_flash_bwd_packed2",
                          [_P] * 11 + [_I] * 5 + [_F, _I, _I, _I, _P]),
    "decode_sweep": ("dl4j_decode_sweep", [_P] * 8 + [_I] * 8 + [_F, _P]),
}

# further C entry points of a source above: entry -> (source, symbol,
# argument types). They share the source's library and its build.
ENTRIES = {
    "decode_attention_q": ("decode_attention", "dl4j_decode_attention_q",
                           [_P] * 7 + [_I] * 7 + [_F, _P]),
    "decode_window_q": ("decode_window", "dl4j_decode_window_q",
                        [_P] * 7 + [_I] * 8 + [_F, _P]),
}

_loaded: Dict[str, ctypes._CFuncPtr] = {}
build_seconds: Dict[str, float] = {}
nvcc_runs: Dict[str, int] = {}
origin: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str, cache=None):
    """Spawn nvcc for one source into a temporary file; returns
    (process, tmp, final) or None when the library is already built or
    came from ``cache``."""
    out = library_path(name)
    if out.exists():
        origin.setdefault(name, "disk")
        if cache is not None:
            cache.publish_library(name, _digest(name), out)
        return None
    if cache is not None and cache.fetch_library(name, _digest(name), out):
        origin[name] = "cache"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    nvcc_runs[name] = nvcc_runs.get(name, 0) + 1
    return proc, tmp, out


def _finish(name: str, started, t0: float, cache=None) -> None:
    """Wait for one nvcc; publish its library (and its ptxas report)
    atomically."""
    if started is None:
        return
    proc, tmp, out = started
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{err}")
    out.with_suffix(".log").write_text(err)
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    origin[name] = "nvcc"
    if cache is not None:
        cache.publish_library(name, _digest(name), out)


def build_all() -> None:
    """Build every kernel source in parallel (one nvcc each, all started
    together)."""
    ensure_built(*SIGNATURES)


def ensure_built(*srcs: str, cache=None) -> Path:
    """Each source's library on disk: built already, from ``cache`` (a
    compile cache, see the module docstring), or by nvcc now (one nvcc
    per source, all started together; published into ``cache``).
    Returns the last one's path; loads nothing."""
    t0 = time.perf_counter()
    started = {s: _start(s, cache) for s in srcs}
    for s, st in started.items():
        _finish(s, st, t0, cache)
    return library_path(srcs[-1])


def load(name: str) -> ctypes._CFuncPtr:
    """The C entry point ``name`` (a source of `SIGNATURES` or an entry of
    `ENTRIES`), its source built first if needed."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    if name in ENTRIES:
        src, sym, argtypes = ENTRIES[name]
    else:
        src = name
        sym, argtypes = SIGNATURES[name]
    lib = ctypes.CDLL(str(ensure_built(src)))
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _loaded[name] = fn
    return fn


def dtype_code(dtype) -> int:
    import torch
    codes = {torch.float32: DTYPE_F32, torch.float16: DTYPE_F16,
             torch.bfloat16: DTYPE_BF16}
    if dtype not in codes:
        raise TypeError(f"CUDA kernels take float32, float16 or bfloat16, "
                        f"got {dtype}")
    return codes[dtype]


def cache_code(dtype) -> int:
    """The C interface's code of a quantized KV cache's value dtype."""
    import torch
    codes = {torch.int8: DTYPE_I8}
    if hasattr(torch, "float8_e4m3fn"):
        codes[torch.float8_e4m3fn] = DTYPE_E4M3
    if dtype not in codes:
        raise TypeError(f"quantized CUDA kernels take an int8 or "
                        f"float8_e4m3fn cache, got {dtype}")
    return codes[dtype]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def _demangle(names):
    """C++ names of mangled symbols (c++filt), in order; the mangled names
    themselves where c++filt is missing."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def parse_ptxas(text: str) -> Dict[str, dict]:
    """{kernel instance: {"registers", "stack_frame", "spill_stores",
    "spill_loads"}} (the last three in bytes) from nvcc's -Xptxas -v
    output, instance names demangled."""
    stats: Dict[str, dict] = {}
    current = None
    lines = text.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            current = m.group(1)
            stats.setdefault(current, {})
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m and i + 1 < len(lines):
            sp = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", lines[i + 1])
            if sp and m.group(1) in stats:
                stats[m.group(1)].update(stack_frame=int(sp.group(1)),
                                         spill_stores=int(sp.group(2)),
                                         spill_loads=int(sp.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and current is not None:
            stats[current]["registers"] = int(m.group(1))
    return dict(zip(_demangle(list(stats)), stats.values()))


def ptxas_report(name: str) -> Dict[str, dict]:
    """`parse_ptxas` of the report kept beside the built library of
    source ``name`` (build it first)."""
    return parse_ptxas(library_path(name).with_suffix(".log").read_text())


def count_mma(sass: str) -> Dict[str, int]:
    """{kernel instance: number of HMMA / HGMMA instructions} in
    `cuobjdump -sass` output, instance names demangled."""
    counts: Dict[str, int] = {}
    current = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current is not None and re.search(r"\bH(G)?MMA\b", ln):
            counts[current] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


def sass_mma_counts(name: str) -> Dict[str, int]:
    """`count_mma` of the built library of source ``name``."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    return count_mma(subprocess.run(
        [str(tool), "-sass", str(library_path(name))], capture_output=True,
        text=True, check=True).stdout)
