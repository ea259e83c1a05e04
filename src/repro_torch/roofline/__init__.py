"""Roofline arithmetic on the H100: bytes, operations and their bounds."""
