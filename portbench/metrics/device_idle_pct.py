"""The share of the profiled stretch in which no kernel, copy or memset ran
on the device (``torch.profiler``'s trace); nothing where the trace saw no
device work."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
