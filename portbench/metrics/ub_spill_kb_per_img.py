"""Kilobytes an image that the plan's kernel groups write to HBM for another
group to read back (each spilled intermediate written once and read once
by each group that reads it): the program's counter
``compile.spill_bytes_per_img`` over ``compile.plans``, both added by each
compile that misses the pipeline cache.  0 where every unified buffer stays
on chip; nothing where the program has no such counters."""

from portbench import program


def read(rec):
    plans = program.counter("compile.plans")
    spill = program.counter("compile.spill_bytes_per_img")
    if not plans or spill is None:
        return None
    return spill / plans / 1e3
