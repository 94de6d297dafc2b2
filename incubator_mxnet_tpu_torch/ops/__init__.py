"""Operator implementations; importing ``ndarray`` registers them."""
