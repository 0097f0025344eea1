"""Codec, policy, compressed reductions and TP layers of the port."""
