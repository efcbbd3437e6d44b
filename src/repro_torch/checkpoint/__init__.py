"""``repro_torch.checkpoint`` (twin of ``repro.checkpoint``): atomic,
async checkpoints in the reference's on-disk layout."""
