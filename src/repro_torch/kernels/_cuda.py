"""Build and bind the hand-written CUDA kernels of ``kernels/csrc/``.

Each source is one ``.cu`` file with a plain C interface: for each kernel
in it an ``extern "C" int <name>_launch(...)`` that takes device pointers,
the dims and a stream, launches that kernel on that stream and returns
``cudaGetLastError()``, and ``kernel_error_string``.  A source may include
headers of ``csrc/`` (``#include "sm90.cuh"``, the Hopper building blocks
of the tensor-core kernels, ``cp_async.cuh`` the SIMT matmul's
asynchronous copies): ``CudaLauncher.source()`` splices each one's
text in place of its ``#include`` line, so the build, which compiles the
source text alone, finds it, and the build's digest covers it.  The text is
built at first use by ``backend.build.load_library``, so it gets the same
nvcc flags as the generated pipeline kernels (``sm_90a``, ``-O3
-fmad=false``, never fast math; a kernel that wants a fused multiply-add
writes ``__fmaf_rn``, which the flag leaves fused) and the same
``build/torch_kernels/<sha256>/`` cache, and is bound with ``ctypes``.
Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path
from typing import Sequence

import torch

from ..backend.build import load_library

CSRC = Path(__file__).resolve().parent / "csrc"

DTYPES = (torch.float32, torch.bfloat16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INCLUDE = re.compile(r'^#include "(\w+\.cuh)"$', re.MULTILINE)


def check_dtypes(fn: str, *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype ``tensors`` share; ``TypeError`` unless it is float32
    or bfloat16, the dtypes the JAX package's kernel tests sweep."""
    dtype = tensors[0].dtype
    if dtype not in DTYPES:
        raise TypeError(f"{fn}: dtype {dtype} is not supported; use float32 or bfloat16")
    for t in tensors[1:]:
        if t.dtype != dtype:
            raise TypeError(f"{fn}: operands must share one dtype, got {dtype} and {t.dtype}")
    return dtype


def tma_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s data contiguous from a 16-byte boundary, as TMA reads a
    base: ``t.contiguous()`` itself, or a fresh copy of it (a fresh
    allocation is always aligned)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require_cuda(fn: str, *tensors: torch.Tensor, meta: bool = False) -> torch.device:
    """The one CUDA device ``tensors`` lie on; ``ValueError`` otherwise (the
    plain version is asked for by name, ``kernels="eager"``).  ``meta``:
    meta tensors are taken too, for an entry whose fake implementation
    gives the output's shape and dtype without computing anything (the dry
    run, ``launch.dryrun``).  A tensor that needs a gradient raises too: a
    direct kernel call records nothing for autograd, and its output would
    cut the graph without a word; the differentiable route is
    ``ops.attention_op`` / ``ops.ssd_op``."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{fn}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type != "cuda" and not (meta and dev.type == "meta"):
        raise ValueError(
            f"{fn}: the CUDA kernel takes CUDA tensors, got {dev}; use "
            "kernels='eager' for the plain version on the CPU"
        )
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{fn}: a direct kernel call records no backward; differentiate through "
            "kernels.ops.attention_op / kernels.ops.ssd_op (kernel forward, the plain "
            "version's gradient), or run the kernel under torch.no_grad()"
        )
    return dev


class CudaLauncher:
    """The ``ctypes`` entry of one hand-written kernel, ``<name>_launch`` in
    ``csrc/<file>.cu`` (``file`` defaults to ``name``), which launches that
    one kernel, and its count of launches.  ``argtypes`` are the launcher's
    arguments before the trailing stream; ``replaces`` names the Pallas
    kernel it ports, by ``file:line``."""

    def __init__(self, name: str, argtypes: Sequence[type], replaces: str, file: str = ""):
        self.name = name
        self.file = file or name
        self.replaces = replaces
        self.launches = 0
        self._argtypes = list(argtypes)
        self._fn = None
        self._err = None

    @property
    def path(self) -> Path:
        return CSRC / f"{self.file}.cu"

    def source(self) -> str:
        """The source as it is built: the ``.cu`` text with each
        ``#include "<header>.cuh"`` replaced by that header of ``csrc/``."""
        return _INCLUDE.sub(lambda m: (CSRC / m.group(1)).read_text(), self.path.read_text())

    def symbol(self, name: str, argtypes: Sequence[type], restype: type = ctypes.c_int):
        """Another C function of the launcher's library (built at first
        use), with its ``argtypes`` and ``restype`` set."""
        fn = getattr(load_library(self.source()), name)
        fn.argtypes, fn.restype = list(argtypes), restype
        return fn

    def _bind(self) -> None:
        lib = load_library(self.source())
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes = self._argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raises ``RuntimeError``
        with CUDA's message when the launch is refused."""
        if self._fn is None:
            self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: launch refused: {self._err(rc).decode()} (cudaError {rc})"
            )
        self.launches += 1


__all__ = [
    "CSRC", "CudaLauncher", "DTYPES", "DTYPE_CODE", "check_dtypes", "needs_grad", "require_cuda",
    "tma_aligned",
]
