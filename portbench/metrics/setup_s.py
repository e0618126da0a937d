"""Process start until the window opens: imports, CUDA context, plan,
verify, emit, the library's load (its nvcc build on a cell's first run),
the input pool and the warm-up."""


def read(rec):
    return rec["setup_s"]
