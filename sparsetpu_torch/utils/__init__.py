"""Utilities of the port: the library comparator (``utils.bcoo``), numpy
copies of the JAX package's ``utils.stdrng`` (ChaCha12 ``StdRng``) and
``utils.oracle`` (the dict-of-coordinates oracle), and the K-ary search tree
``utils.dense_btree`` (host structures in numpy, the lookup on the device)."""
