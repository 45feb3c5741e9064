"""Host utilities of the port (copies of the jax-free `time_r1_tpu/utils/` it needs)."""
