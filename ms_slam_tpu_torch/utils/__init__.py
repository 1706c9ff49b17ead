"""Numpy-only host utilities: rendered test worlds (`synth`) and trajectory
evaluation (`evaluate`). Both are the port's own copies of the reference's
modules of the same names."""
