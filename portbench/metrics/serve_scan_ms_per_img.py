"""Host milliseconds of the output scan per served image: the program's
``serve.scan`` spans (``np.isfinite`` over each live slot's outputs) in the
profiled stretch over the requests its ``serve.step`` spans took."""

from portbench import program


def read(rec):
    return program.ms_per_img("serve.scan")
