"""The harness of the port's benchmark (``port_bench/run.py``)."""
