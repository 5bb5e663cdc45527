"""The MAP graph and its principal-bundle decomposition, on the host."""
