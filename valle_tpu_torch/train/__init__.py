"""Training of the port: state and the train / eval steps (the twin of
``valle_tpu/train``; checkpoints, metrics tracking and the debug helpers are
not ported yet)."""
