"""Host milliseconds of the serve bridge per served image: the harness's
host-clock spans around ``submit`` and ``step`` over the window, less the
generated kernels' device time (CUDA events around the ``_run_pipeline``
seam)."""


def read(rec):
    if rec.get("seam_s") is None or not rec.get("images"):
        return None
    return 1e3 * (rec["host_s"] - rec["seam_s"]) / rec["images"]
