"""The benchmark of ``qmg_tpu_torch``: one cell run once by
``python -m benchmark.run``; see ``run.py``."""
