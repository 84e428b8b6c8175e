"""Measurement probes of the port on the card (the counterparts of the
repo's ``benchmarks/`` scripts)."""
