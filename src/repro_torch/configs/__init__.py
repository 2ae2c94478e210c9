"""Model configurations of the port (the LM and recsys parts of the
reference's ``configs`` package)."""
