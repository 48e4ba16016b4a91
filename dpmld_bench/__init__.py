"""The port's benchmark: ``python3 -m dpmld_bench.run`` runs one cell once (``run.py``)."""
