"""Checkpoint I/O in the JAX package's flax msgpack layout."""
