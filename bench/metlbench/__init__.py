"""The benchmark harness of ``repro_torch``: one cell a run (``bench/run.py``)."""
