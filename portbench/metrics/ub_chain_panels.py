"""Hidden panels a block of the plan's chained groups walks (a group that
chains two reductions through a hidden axis held in shared memory a panel at
a time, ConvNeXt's MLP): the program's counter ``compile.chain_panels`` over
``compile.plans``, both added by each compile that misses the pipeline
cache.  Fewer is a wider panel, so fewer copies and barriers a block;
nothing where no plan chained a group (``compile.chain_groups``) or the
program has no such counters."""

from portbench import program


def read(rec):
    plans = program.counter("compile.plans")
    panels = program.counter("compile.chain_panels")
    if not plans or not program.counter("compile.chain_groups"):
        return None
    return panels / plans
