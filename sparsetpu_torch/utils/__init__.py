"""Utilities of the port: the library comparator (``utils.bcoo``)."""
