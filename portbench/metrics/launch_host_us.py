"""Host microseconds of one ``TorchPipeline.run`` on an idle queue
(synchronize, then time until the call returns), the mean over the traced
run's stretch of such calls."""


def read(rec):
    calls = rec.get("launch_host_s")
    return 1e6 * sum(calls) / len(calls) if calls else None
