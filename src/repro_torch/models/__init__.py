"""The dense decoder: config, layers, attention, the stack."""
