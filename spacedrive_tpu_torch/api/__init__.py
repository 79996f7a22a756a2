"""API procedures of the port (trimmed to the search and jobs handlers)."""


class ApiError(Exception):
    """A request the procedure refuses (the JAX package's
    ``api.router.ApiError``)."""
