"""Mean seconds a scan spends in the ring's registration (the ``timing``
of ``scan_stacks_to_cloud``), over the traced run's timed scans."""


def read(lc):
    return lc.mean_timing("register_s")
