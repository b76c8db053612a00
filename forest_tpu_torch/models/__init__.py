"""Model modules of the port (torch.nn, channel-last public layout)."""
