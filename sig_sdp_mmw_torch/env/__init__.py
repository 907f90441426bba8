"""Scenario generation, PHY model and sparse BLER evaluation."""
