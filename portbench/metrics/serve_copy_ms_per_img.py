"""Host milliseconds of the copies per served image: the program's
``serve.h2d`` and ``serve.d2h`` spans (the D2H waits for the dispatch's
kernels too) in the profiled stretch over the requests its ``serve.step``
spans took."""

from portbench import program


def read(rec):
    return program.ms_per_img("serve.h2d", "serve.d2h")
