"""IR metrics of the /eval route (counterparts of the JAX package's evals/)."""
