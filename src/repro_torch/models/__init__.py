"""Models of the port: the decoder's layers and dense transformer, and
the recsys models."""
