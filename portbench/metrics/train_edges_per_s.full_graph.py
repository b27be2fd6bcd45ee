"""Training edges per second over full-graph steps of one large graph: the real edges of every
step the window completed, times the message layers, over the window's
whole time (host clock)."""

from portbench.readers import edges_per_s as read  # noqa: F401
