"""The device's idle share (%) of the traced steps, full-graph steps of one large graph:
1 - (union of device activity) / (the traced range), both from one
trace."""

from portbench.readers import device_idle_share as read  # noqa: F401
