"""Host helpers of the port (jax-free copies; see each module)."""
