"""Images completed over the whole window, per second of it (served cells:
arrivals or callers stop at the window's seconds, and it closes when the
last reply is back)."""


def read(rec):
    return rec["images"] / rec["window_s"] if rec.get("latencies_s") is not None else None
