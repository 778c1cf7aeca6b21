"""Command-line trainers of the port's learned helpers (counterparts of the
JAX package's ``script/train_refiner.py`` and ``script/train_iknet.py``)."""
