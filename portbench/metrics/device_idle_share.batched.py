"""The device's idle share (%) of the traced steps, epochs of small graphs in batches (the ZINC cell):
1 - (union of device activity) / (the traced range), both from one
trace."""

from portbench.readers import device_idle_share as read  # noqa: F401
