"""Resident: batches of ``batch_slots`` images already on the card, run
round-robin through ``compile_pipeline(..., batch=B, batch_capacity=B)``
and ``TorchPipeline.run`` back to back until the window's seconds have
passed; the window ends with ``torch.cuda.synchronize()``.  No serve bridge.

Parameters (``traffic/<mix>.json``): ``batches``, the number of batches in
the pool (enough that the pool outgrows the card's L2, so every dispatch
reads from HBM).  A traced run then times ``LAUNCH_CALLS`` calls of ``run``
on an idle queue.
"""

from __future__ import annotations

from portbench.harness import Run, clock

LAUNCH_CALLS = 200


def drive(run: Run) -> dict:
    from repro_torch.backend import compile_pipeline

    slots, count = run.slots, run.traffic["batches"]
    pp = compile_pipeline(run.app().pipeline, batch=slots, batch_capacity=slots, cache=True,
                          device=run.device, kernels=run.kernels)
    run.mark("plan, verify, emit, load")
    shared = {n for n, s in run.config["inputs"].items() if s.get("shared")}
    pool = {n: t.expand(slots, *t.shape[1:]).contiguous() if n in shared else t
            for n, t in run.pool(slots * count).items()}
    batches = [{n: t if n in shared else t[j * slots:(j + 1) * slots] for n, t in pool.items()}
               for j in range(count)]
    run.mark("pool")
    names = [k.name for k in pp.kernels]
    sample = run.sample()
    # warm-up: as many outputs alive at once as the sample will hold
    warm = [pp.run(batches[j % count]) for j in range(sample.k + 2)]
    run.sync()
    del warm
    run.tracer.warm()
    run.sync()
    run.mark("warm-up")
    t0, i = clock(), 0
    while True:
        now = clock()
        if now - t0 >= run.seconds:
            break
        run.tracer.tick(now - t0, i)
        with run.tracer.span("run"):
            out = pp.run(batches[i % count])
        sample.offer((i % count, {k: out[k] for k in names}))
        i += 1
    run.tracer.finish(i)
    run.sync()
    t1 = clock()
    launch = []
    if run.tracer.traced:
        for j in range(LAUNCH_CALLS):
            run.sync()
            t = clock()
            pp.run(batches[j % count])
            launch.append(clock() - t)
        run.sync()
    return {
        "setup_s": t0 - run.t_start,
        "window_s": t1 - t0,
        "attempted": i * slots,
        "images": i * slots,
        "missing": 0,
        "dispatches": i,
        "launch_host_s": launch,
        "items": sample.items,
        "inputs_of": batches.__getitem__,
        "close": lambda: None,
    }
