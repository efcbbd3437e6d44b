"""``repro_torch.optim`` (twin of ``repro.optim``): AdamW and int8
gradient compression."""
