"""The 90th percentile of the window's step times, each the interval
between the CUDA events recorded after consecutive ``Trainer.train()``
calls: when the device finished each step, whether or not the host ran
ahead. Over every step of the window (linear interpolation)."""

import numpy as np


def read(rec):
    if rec["kind"] != "train" or len(rec["step_ms"]) < 2:
        return None
    return float(np.percentile(np.asarray(rec["step_ms"], np.float64), 90))
