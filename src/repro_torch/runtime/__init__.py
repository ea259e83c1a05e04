"""The port's training loop."""
