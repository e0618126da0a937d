"""Host microseconds of one ``TorchPipeline.run`` on a full queue: the mean
of the program's ``pipeline.run`` spans in the profiled stretch (where
``launch_host_us`` times the call on an idle queue)."""

from portbench import program


def read(rec):
    runs = program.durations_ns("pipeline.run")
    return 1e-3 * sum(runs) / len(runs) if runs else None
