"""Applications built on the port's runtime."""
