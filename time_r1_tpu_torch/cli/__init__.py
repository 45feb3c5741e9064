"""Command-line entry points of the port (port of `time_r1_tpu/cli/`)."""
