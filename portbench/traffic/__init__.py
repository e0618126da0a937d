"""Traffic: each mix is a data file, ``traffic/<mix>.json``, whose ``kind``
names the generator here that reads it (``traffic/<kind>.py``, with
``drive(run) -> record``): ``open`` (arrivals on a schedule, served),
``closed`` (callers that wait for their reply, served) and ``resident``
(batches already on the card, run back to back)."""
