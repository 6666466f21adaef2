"""Seconds from the start of the process to the first timed unit:
imports, the kernels' build or load, weights, inputs and warm-up."""


def read(rec):
    return rec["setup_s"]
