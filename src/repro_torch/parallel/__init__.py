"""Multi-device layout: logical-axis sharding rules and the ``Sharder``
(``sharding.py``), and GPipe pipeline stages (``pipeline.py``), over
``torch.distributed`` process groups."""
