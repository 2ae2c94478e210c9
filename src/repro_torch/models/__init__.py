"""Decoder models of the port: layers and the dense transformer."""
