"""``repro_torch.launch`` — entry points run as ``python -m`` modules
(twin of ``repro.launch``): ``serve`` stands a RALM deployment up and
drives it, in-process or behind the HTTP gateway."""
