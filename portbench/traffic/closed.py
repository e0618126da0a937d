"""Closed loop through ``PipelineServer``: ``clients`` callers, each with one
request outstanding, each sending its next as soon as its reply returns,
until the window's seconds have passed; then the last replies are drained.

Parameters (``traffic/<mix>.json``): ``clients``; ``pool``, the number of
distinct images drawn from the seed, of which each request takes one.
"""

from __future__ import annotations

from portbench.harness import Run, Served, clock


def drive(run: Run) -> dict:
    served = Served(run)
    server = served.server
    t0 = clock()
    for _ in range(run.traffic["clients"]):
        served.submit(served.pick(), clock())
    while server.pending:
        run.tracer.tick(clock() - t0, server.dispatches)
        done, end = served.step()
        if end - t0 < run.seconds:
            for _ in done:                       # each caller sends again on its reply
                served.submit(served.pick(), end)
    t1 = clock()
    run.tracer.finish(server.dispatches)
    rec = served.record(t0, t1)
    rec["close"] = served.close
    return rec
