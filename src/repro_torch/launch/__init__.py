"""Launchers: the train driver."""
