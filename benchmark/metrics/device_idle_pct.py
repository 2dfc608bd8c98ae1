"""device_idle_pct: the share of one traced whole fit in which no
operation ran on the device (1 minus the union of the device's activity
intervals over the traced window, from torch.profiler), in %."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
