"""Runtime support shared by serving and (later) training."""
