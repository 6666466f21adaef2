"""Milliseconds of an extraction call's phase 1 and state capture, from
the program's ``stage_walls`` (synchronised at each stage's end), the mean
over the window's calls."""


def read(rec):
    if rec["kind"] != "attfind":
        return None
    walls = [s["capture_states"] for s in rec["stage_walls"] if s and "capture_states" in s]
    return 1e3 * sum(walls) / len(walls) if walls else None
