"""Training edges per second over epochs of small graphs in batches (the ZINC cell): the real edges of every
step the window completed, times the message layers, over the window's
whole time (host clock)."""

from portbench.readers import edges_per_s as read  # noqa: F401
