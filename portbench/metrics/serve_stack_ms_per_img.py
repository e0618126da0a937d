"""Host milliseconds of batching per served image: the program's
``serve.stack`` spans (zero fillers, ``np.stack`` of each input, its tensor)
in the profiled stretch over the requests its ``serve.step`` spans took."""

from portbench import program


def read(rec):
    return program.ms_per_img("serve.stack")
