"""``repro_torch.data`` (twin of ``repro.data``): the deterministic token
pipeline."""
