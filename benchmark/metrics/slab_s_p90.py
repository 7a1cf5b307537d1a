"""The 90th percentile of the walls of all the window's slabs (host
clock, each slab ended by a synchronize; linear interpolation)."""
import numpy as np


def read(summary):
    walls = summary["window"]["slab_walls_s"]
    return float(np.percentile(walls, 90)) if walls else None
