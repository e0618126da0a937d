"""The 95th percentile (nearest rank) of the time a request waits in the
server's queue: the program's ``serve.queued`` spans, from the end of its
admission to the start of the ``step()`` that takes it, for each request
admitted in the profiled stretch."""

import math

from portbench import program


def read(rec):
    waits = sorted(program.durations_ns("serve.queued"))
    if not waits:
        return None
    return 1e-6 * waits[math.ceil(0.95 * len(waits)) - 1]
