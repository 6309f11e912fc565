"""90th percentile of every step of the window, from the start of
``get_batch_device`` to the loss read on the host. Host clock."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.step_s) * 1e3, 90))
