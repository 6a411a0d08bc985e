"""Launchers: the HPO driver and its chunk planner."""
