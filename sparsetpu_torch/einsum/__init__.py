"""Einsum of the port: the spec parser (``einsum.parser``), ported from
``sparsetpu.einsum``; the engine is still to be ported."""
