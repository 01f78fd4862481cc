"""The training data streams of the port."""
