"""Render function and Trainer (render half) of the port."""
