"""Plain references, one module per app (``reference/<app>.py``), each with
``reference(inputs, precision)``: whole-image PyTorch expressions of the
app's math on batched inputs (a leading image axis), returning
``{kernel name: batched output}``.  They import nothing of the port, of
JAX or of the JAX package, and take nothing the port made.  ``precision``
is the configuration's ``float32`` or a lower one for the control.  Each
also has ``work(**kwargs)``: the bytes and FLOPs of one image, counted from
the app's definition at the configuration's ``kwargs`` (see ``work.py``)."""

import importlib


def module(app: str):
    return importlib.import_module(f"portbench.reference.{app}")


def get(app: str):
    return module(app).reference
