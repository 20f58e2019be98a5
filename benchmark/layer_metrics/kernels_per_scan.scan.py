"""Device kernels a scan launches, in the profiled slice."""


def read(lc):
    return lc.kernels_per_request()
