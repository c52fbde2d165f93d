"""Distributed state of training: the ITC queue."""
