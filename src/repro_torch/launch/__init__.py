"""The port's launchers: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve`` (the JAX package's
``repro.launch.{train,serve}``).  The mesh helpers and the dry run
(``launch/{mesh,dryrun}.py``) come with the port of ``distributed/``."""
