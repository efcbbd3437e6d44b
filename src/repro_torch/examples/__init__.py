"""Examples run as ``python -m repro_torch.examples.<name>`` (twins of the
repository's ``examples/`` scripts)."""
