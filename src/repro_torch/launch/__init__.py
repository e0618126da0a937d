"""The port's launchers and mesh helpers: ``python -m repro_torch.launch.train``
and ``python -m repro_torch.launch.serve`` (the JAX package's
``repro.launch.{train,serve}``), and ``launch.mesh`` (process groups,
device meshes, the production mesh shapes).  The dry run
(``launch/dryrun.py``) is not ported yet (ROADMAP Queue 1 item 11)."""
