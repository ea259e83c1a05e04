"""Optimizer and gradient compression of the port's training path."""
