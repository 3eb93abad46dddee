"""Posit formats, the plain PyTorch codec and the quantization policy."""
