"""Seconds of set-up spent building the kernels: the program's counter
``compile.build_s`` (lowering each group, then the CUDA library's emit, its
nvcc build where no build is cached, and its load)."""

from portbench import program


def read(rec):
    return program.counter("compile.build_s")
