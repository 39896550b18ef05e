"""Utilities of the port: the library comparator (``utils.bcoo``), and
numpy copies of the JAX package's ``utils.stdrng`` (ChaCha12 ``StdRng``)
and ``utils.oracle`` (the dict-of-coordinates oracle)."""
