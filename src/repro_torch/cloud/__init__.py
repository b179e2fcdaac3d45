"""Offload fabric of the port. Only the content manifests (``wire``) are
ported so far; the broker, pool and workers come with the fabric slice."""
