"""Device activities (kernels, copies, memsets) of the traced request over
its denoise steps, the benchmark's markers left out: an exact count of the
host's dispatch."""


def read(rec):
    coarse = rec["coarse"]
    if coarse is None:
        return None
    return len(coarse["activities"]) / rec["steps"]
