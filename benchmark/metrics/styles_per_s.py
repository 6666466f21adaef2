"""Styles (perturbed generator and classifier forwards) completed per
second: every style of the window's whole extraction calls over the
window's wall time, phase 1, the state capture and the copies included."""


def read(rec):
    if rec["kind"] != "attfind" or rec["window_s"] <= 0:
        return None
    return rec["styles"] / rec["window_s"]
