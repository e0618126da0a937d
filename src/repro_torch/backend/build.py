"""Build the generated CUDA sources with ``nvcc`` and load them with ctypes.

Each compiled pipeline is one ``.cu`` source (``cuda_codegen.emit_library``)
that includes only ``csrc/ub_kernel.cuh``.  It is compiled at first use into
``build/torch_kernels/<sha256>/libub.so`` under the repository root (listed
in ``.gitignore``), where the digest covers the source, the header and the
flags, so an unchanged pipeline is never rebuilt.  The flags keep the
kernel's f32 arithmetic identical to the plain PyTorch version's: no fused
multiply-add contraction (``-fmad=false``) and never ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

from .errors import EmitError

CSRC = Path(__file__).resolve().parent / "csrc"
HEADER = CSRC / "ub_kernel.cuh"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# sm_90a code from compute_90a PTX only: wgmma exists for no other target
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise EmitError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def digest(source: str) -> str:
    h = hashlib.sha256()
    h.update(source.encode())
    h.update(HEADER.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path(source: str) -> Path:
    return BUILD_ROOT / digest(source) / "libub.so"


def _start(source: str):
    """Write the source and start nvcc; returns (process, tmp, target, t0)
    or None when the library is already built."""
    so = library_path(source)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    cu = so.parent / "kernels.cu"
    cu.write_text(source)
    tmp = so.parent / f"libub.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, time.perf_counter()


def build_many(sources: Sequence[str]) -> Dict[str, float]:
    """Build every not-yet-built source, all ``nvcc`` processes started
    together; returns ``{digest: seconds}`` for the builds it ran.  Raises
    :class:`EmitError` with nvcc's output if any build fails."""
    started = []
    seen = set()
    for src in sources:
        d = digest(src)
        if d in seen:
            continue
        seen.add(d)
        job = _start(src)
        if job is not None:
            started.append((d, job))
    times: Dict[str, float] = {}
    errors: List[str] = []

    def reap(job):
        # each build is timed at its own exit, not when its turn to be read comes
        proc, _tmp, _so, t0 = job
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(len(started), 1)) as pool:
        reaped = list(pool.map(reap, [job for _d, job in started]))
    for (d, (proc, tmp, so, _t0)), (log, secs) in zip(started, reaped):
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {so.parent}:\n{log}")
            continue
        os.replace(tmp, so)
        (so.parent / "nvcc.log").write_text(log)
        times[d] = secs
        print(f"nvcc {d[:12]}: {secs:.1f} s", file=sys.stderr)
    if errors:
        raise EmitError("\n".join(errors))
    return times


_ENTRY = re.compile(r"Compiling entry function '(_Z\w+)'")


def _demangle(names: Sequence[str]) -> List[str]:
    """Kernel names as ``c++filt -p`` (binutils, beside the host compiler
    nvcc needs) prints them, the anonymous namespace left out:
    ``ub_kernel_0``, ``matmul_kernel<float>``, ``flash_wgmma_kernel<128>``."""
    if not names:
        return []
    tool = shutil.which("c++filt")
    if tool is None:
        raise EmitError("c++filt not found: ptxas_usage names kernels with it")
    run = subprocess.run([tool, "-p"], input="\n".join(names), capture_output=True, text=True,
                         check=True)
    return [n.replace("(anonymous namespace)::", "") for n in run.stdout.splitlines()]


_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(source: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of ``source``'s library, what ``ptxas -v`` reported when
    it was built: ``{"registers", "spill_stores", "spill_loads"}`` (bytes
    for the spills).  Empty when the build's log is not there."""
    log = library_path(source).parent / "nvcc.log"
    if not log.exists():
        return {}
    text = log.read_text()
    names = iter(_demangle(_ENTRY.findall(text)))
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        if _ENTRY.search(line):
            name = next(names)
            out[name] = {}
            continue
        if name is None:
            continue
        m = _SPILLS.search(line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
        m = _REGS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def load_library(source: str) -> ctypes.CDLL:
    """The shared library of ``source``, built first if needed."""
    build_many([source])
    return ctypes.CDLL(str(library_path(source)))


__all__ = [
    "BUILD_ROOT", "NVCC_FLAGS", "build_many", "digest", "library_path", "load_library",
    "ptxas_usage",
]
