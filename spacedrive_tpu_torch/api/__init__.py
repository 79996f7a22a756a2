"""API of the port: the rspc router (:mod:`.router`) and its procedures
(:mod:`.routers`)."""

from .router import ApiError

__all__ = ["ApiError"]
