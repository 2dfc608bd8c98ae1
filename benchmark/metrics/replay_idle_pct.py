"""replay_idle_pct: in the traced fit, the device's idle time inside the
host's ``loop.replay`` range (the program's span on the profiler's clock)
over that range's length, in % (``spans.idle_under``): whether the host
keeps the replays fed."""


def read(rec):
    idle = (rec.get("profile") or {}).get("span_idle", {}).get(
        "loop.replay")
    if not idle or not idle[1]:
        return None
    return 100.0 * idle[0] / idle[1]
