"""Command-line tools of the port (`python -m fiber_torch.tools.<name>`)."""
