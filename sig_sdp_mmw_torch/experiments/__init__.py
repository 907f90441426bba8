"""End-to-end drivers of the ported pipeline."""
