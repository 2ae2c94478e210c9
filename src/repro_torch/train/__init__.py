"""Step factories of the port (the serving part of the reference's
``train`` package)."""
