"""The port's launchers and mesh helpers: ``python -m repro_torch.launch.train``
and ``python -m repro_torch.launch.serve`` (the JAX package's
``repro.launch.{train,serve}``), and ``launch.mesh`` (process groups,
device meshes, the production mesh shapes, fake worlds), and the dry run,
``python -m repro_torch.launch.dryrun`` (``repro.launch.dryrun``: every
production cell traced on meta tensors as one rank of a fake 256 / 512-rank
world, its roofline on H100 constants)."""
