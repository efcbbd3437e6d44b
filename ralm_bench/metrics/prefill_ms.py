"""``prefill_ms``: mean wall time of one admission (``RalmEngine.start``:
slot claim, prefill and the copy into the pool, as far as the host waits
for them), in the traced run's unprofiled part of the window."""


def read(obs):
    host = obs.host
    if not host or not host["admit_s"]:
        return None
    return 1e3 * sum(host["admit_s"]) / len(host["admit_s"])
