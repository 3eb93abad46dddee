"""Logical-axis sharding rules (PyTorch port of `repro.parallel`)."""
