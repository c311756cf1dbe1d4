"""Checkpoints of tensor trees (``store``): the reference's on-disk layout,
so that a checkpoint written by either package restores in the other."""
