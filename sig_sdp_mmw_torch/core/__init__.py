"""Problem state containers (the sparse ELL state)."""
