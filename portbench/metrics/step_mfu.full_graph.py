"""The whole training step's share (%) of the card's float32 peak over
full-graph steps of one large graph: ``portbench/readers.py::step_mfu``."""

from portbench.readers import step_mfu as read  # noqa: F401
