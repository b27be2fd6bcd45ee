"""One driver per entry point a cell's window drives, named by its traffic
file's ``driver``."""
