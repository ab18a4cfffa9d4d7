"""RBF-FD weights and operator assembly."""
