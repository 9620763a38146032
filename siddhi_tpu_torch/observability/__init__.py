"""Observability of the port: the per-junction flight recorder (flight.py)
and event lineage (lineage.py), copied from the JAX package's modules of the
same names (siddhi_tpu/observability/), which the port never imports."""
