"""Host milliseconds of admission per served image: the program's
``serve.admit`` spans (the finiteness scan and the rest of validation, then
routing) in the profiled stretch over the requests its ``serve.step``
spans took."""

from portbench import program


def read(rec):
    return program.ms_per_img("serve.admit")
