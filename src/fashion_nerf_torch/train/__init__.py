"""Training of the port: state, step, loop."""
