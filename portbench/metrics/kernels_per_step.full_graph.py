"""Device kernels per training step, full-graph steps of one large graph: counted in the
profiler's trace of the traced steps (copies and sets not counted)."""

from portbench.readers import kernels_per_step as read  # noqa: F401
