"""Live slots as a share of the slots dispatched: ``stats()``'s served over
dispatches times ``batch_slots``, over the window."""


def read(rec):
    if not rec.get("dispatches") or "served" not in rec:
        return None
    return 100.0 * rec["served"] / (rec["dispatches"] * rec["batch_slots"])
