"""The JAX package's ``examples/`` scripts on the port: ``serve_demo``,
``train_lm`` and ``schedule_explorer`` (``examples/quickstart.py``'s
counterpart is ``repro_torch.quickstart``).  Each runs on the card by
default and on the CPU when asked::

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu --kernels eager]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 150]
    PYTHONPATH=src python -m repro_torch.examples.schedule_explorer [--no-measure | --table-v]

Each ``main(argv)`` returns what it made.  ``--kernels cuda`` (the default)
with ``--device cpu`` raises ``ValueError``, and with no visible GPU the
default device raises: nothing carries on on the CPU by itself
(``launch.train.check_route``).  Prompts, tiles and batches come from
``numpy.random.default_rng(seed)`` where the JAX scripts draw from
``jax.random``, and the weights from a seeded ``torch.Generator``.
"""
