"""Host-side utilities of the port (reference ``paddle_tpu/utils``)."""
