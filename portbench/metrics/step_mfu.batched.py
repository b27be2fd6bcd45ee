"""The whole training step's share (%) of the card's float32 peak over
epochs of small graphs in batches (the ZINC cell): ``portbench/readers.py::step_mfu``."""

from portbench.readers import step_mfu as read  # noqa: F401
