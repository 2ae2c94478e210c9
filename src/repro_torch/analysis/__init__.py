"""Analysis layer of the port: structural invariant validators and the
sanitized (checked) routes of the kernel wrappers, and the seeded
fault-injection harness over recovery."""
