"""Training images per second: the window's steps times the images of
a step, over the window's wall time, which ends in a synchronise."""


def read(rec):
    if rec["kind"] != "train" or rec["window_s"] <= 0:
        return None
    return rec["images"] / rec["window_s"]
