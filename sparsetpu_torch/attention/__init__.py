"""Attention scores of the port: dense, element-sparse (grouped ESC) and block-sparse."""
