"""``wave_ms``: the host's wall time in scheduler steps, less the
admissions inside them, over the decode waves, in the traced run's
unprofiled part of the window (``RalmScheduler.step`` timed by the
harness)."""


def read(obs):
    host = obs.host
    if not host or not host["waves"]:
        return None
    return 1e3 * host["wave_s"] / host["waves"]
