"""Timers and metric tables, random draws, tensor containers, native builds."""
