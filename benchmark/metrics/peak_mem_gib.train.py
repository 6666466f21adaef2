"""The most device memory allocated during the window, in GiB."""


def read(rec):
    if rec["kind"] != "train" or not rec.get("window_peak_bytes"):
        return None
    return rec["window_peak_bytes"] / 2 ** 30
