"""Helpers: device resolution and weight transplant from the JAX package."""
