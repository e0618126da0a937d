"""Images over the whole window of a resident cell, which ends with
``torch.cuda.synchronize()`` after the last dispatch."""


def read(rec):
    return rec["images"] / rec["window_s"] if "launch_host_s" in rec else None
