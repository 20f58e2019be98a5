"""Mean seconds a scan spends decoding and triangulating its stops (the
``timing`` of ``scan_stacks_to_cloud``, drained at each stage edge), over
the traced run's timed scans."""


def read(lc):
    return lc.mean_timing("decode_triangulate_s")
