"""Training of the port, the twin of ``valle_tpu/train``: the state, the
train and eval steps, checkpoints (``checkpoint.py``), the metrics tracker
(``metrics.py``) and the ``--inf-check`` helpers (``debug.py``)."""
