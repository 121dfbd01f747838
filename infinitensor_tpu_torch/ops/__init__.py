"""Graph operators: shape rules and their lowering to torch."""
