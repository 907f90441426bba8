"""schedule_s: seconds to a verified schedule, the window's time over the
schedules it completed (host clock)."""


def read(rec):
    n = len(rec["answers"])
    return rec["window_s"] / n if n else None
