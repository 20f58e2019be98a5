"""``nearest_one``'s share of its roofline over the profiled slice: the
sum of each launch's bound (``peaks.KERNELS``) over the sum of its device
time."""


def read(lc):
    return lc.roofline_pct("nearest_one")
