"""Einsum of the port: the spec parser (``einsum.parser``, a copy of
``sparsetpu.einsum.parser``) and the runtime engine (``einsum.engine``)."""

from .engine import einsum
from .parser import EinsumSpec, InvalidSpec, parse_spec, validate_dims

__all__ = ["einsum", "EinsumSpec", "InvalidSpec", "parse_spec", "validate_dims"]
