"""Procedure handlers, as plain functions ``(node, library, arg)``."""
