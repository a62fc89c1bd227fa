"""Distributed training: rank groups (``network.py``), their layout
(``mesh.py``) and the parallel tree learners (``learners.py``), the port
of ``lightgbm_tpu/parallel/``."""
