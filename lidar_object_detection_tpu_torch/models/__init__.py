"""Detector models of the port."""
