"""Pose geometry of the port."""
