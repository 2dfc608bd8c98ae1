"""loop_overhead_pct: the share of the window's fits' wall time (host
clock) spent outside the captured loop's replays (the port's ``Marks``
between replays): eager warm-up, capture, per-fit set-up and the reads
after the loop, in %."""


def read(rec):
    fits = rec.get("fits")
    if not fits:
        return None
    wall = sum(f.wall_s for f in fits)
    return 100.0 * (wall - sum(f.replay_s for f in fits)) / wall
