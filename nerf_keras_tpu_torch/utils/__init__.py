"""Checkpoint IO, display conversions and PNG codec of the port."""
