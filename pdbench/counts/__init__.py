"""Operation and byte counts as functions of shapes: the yardstick of the
rooflines and of `mfu`."""
