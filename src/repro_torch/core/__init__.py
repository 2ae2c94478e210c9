"""Index core of the port: pointers, slice pools, segments, queries."""
