"""Closed-form work models of the batched LP solvers (``lp_perf``)."""
