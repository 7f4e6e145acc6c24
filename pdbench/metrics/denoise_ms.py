"""Device milliseconds per CFG evaluation of the denoiser (the ControlNet and
the UNet or MMDiT on the CFG batch), from the stage spans of the traced
request: the device time inside the "denoise" spans over the steps."""


def read(rec):
    coarse = rec["coarse"]
    if coarse is None:
        return None
    calls = [c for c in coarse["calls"] if c["key"] == ("stage", "denoise")]
    if not calls:
        return None
    return sum(c["total_us"] for c in calls) / 1e3 / rec["steps"]
