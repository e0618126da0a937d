"""Seconds of set-up spent planning and verifying: the program's counters
``compile.plan_s`` and ``compile.verify_s``, which every compile that
misses the pipeline cache adds to."""

from portbench import program


def read(rec):
    return program.counter("compile.plan_s", "compile.verify_s")
