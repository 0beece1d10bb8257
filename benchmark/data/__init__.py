"""Data generators, one module a family of deployments."""
