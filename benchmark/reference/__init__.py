"""Plain PyTorch reference of the released nets; imports nothing of the measured program."""
