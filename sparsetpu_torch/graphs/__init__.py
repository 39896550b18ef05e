"""Graphs of the port, from ``sparsetpu.graphs``: the host generators
(``generate``, ``datasets``), the dense int8 pattern engine (``patterns``)
and the graph algorithms (``algos``)."""
