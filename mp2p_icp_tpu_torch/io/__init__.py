"""Log records of ICP runs (numpy copies of the JAX package's io modules)."""
