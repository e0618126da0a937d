"""Open loop through ``PipelineServer``: requests arrive on a schedule drawn
from the seed whatever the server does, and each is timed from when it was
due.  One thread submits every request that is due, then calls ``step()``.

Parameters (``traffic/<mix>.json``): ``rate_per_s``, the offered rate;
``pool``, the number of distinct images drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import Run, Served, clock


def schedule(rate_per_s: float, pool: int, seconds: float, arrivals_rng, picks_rng):
    """Arrivals at ``rate_per_s`` over ``[0, seconds)`` with exponential
    gaps, as a Poisson process has: ``round(rate * seconds)`` gaps at the
    midpoints of the exponential distribution's quantiles, scaled to fill
    the window, in an order drawn from the seed.  Every seed offers the same
    work and the same set of gaps, in another order; the image of each
    request is drawn from ``pool``."""
    n = int(round(rate_per_s * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    arrivals_rng.shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]]), picks_rng.integers(0, pool, n)


def drive(run: Run) -> dict:
    served = Served(run)
    p = run.traffic
    arrivals, picks = schedule(p["rate_per_s"], p["pool"], run.seconds, run.rng(0), served.picks)
    server, n, i, backlog = served.server, len(arrivals), 0, None
    t0 = clock()
    while i < n or server.pending:
        now = clock()
        run.tracer.tick(now - t0, server.dispatches)
        while i < n and t0 + arrivals[i] <= now:
            served.submit(int(picks[i]), t0 + arrivals[i])
            i += 1
        if i == n and backlog is None:
            backlog = len(server.pending)        # queued when the last request arrived
        if server.pending:
            served.step()
        elif i < n:
            with run.tracer.span("wait"):
                time.sleep(max(0.0, t0 + arrivals[i] - clock()))
    t1 = clock()
    run.tracer.finish(server.dispatches)
    rec = served.record(t0, t1)
    rec.update(offered=n, backlog_at_close=backlog or 0, close=served.close)
    return rec
