"""Filter models of the port (face detection so far)."""
