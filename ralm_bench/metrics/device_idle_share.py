"""``device_idle_share``: the share of the profiled window in which no
kernel, copy or set ran on the card."""


def read(obs):
    tr = obs.trace
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
