"""Model configurations of the port (the LM part of the reference's
``configs`` package)."""
