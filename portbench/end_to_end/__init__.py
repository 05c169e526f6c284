"""End-to-end metrics, one module a metric: read(run) -> value or None.

`run` is {"cell": harness.spec.Cell, "ranks": [each rank's report from
harness/rank.py], "traced": bool}.  Every value is from the host's clock.
"""
