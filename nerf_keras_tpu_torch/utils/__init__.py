"""Checkpoint IO, storage, images (resize, PNG codec, panels), metrics,
history and profiling helpers of the port."""
